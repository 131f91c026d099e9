"""Tensor parallelism of xLSTM (``mlstm`` and ``slstm`` on a rank's blocks) against the port's unsharded run and
the reference's GSPMD run, on the CPU (``test_torch_tp_families.py``'s
machinery and checks; its docstring says what each holds).

Configs: reduced xLSTM (4 heads of 16: whole heads at model
2 and 4, the state split by heads), and a 2-head xLSTM (heads of 32: at
model 4 a rank's q block is half a head, as xLSTM-125M's is a quarter of
one at 16, so its state splits C's and n's key axis and ``q C`` and
``q n`` are summed over ``model``; ``wi`` / ``wf`` and the stabiliser
``m`` stay whole).  xLSTM has no pool and runs no kernel; its sLSTM
gathers the rank's gate columns once a step.
"""
import pytest

from test_torch_tp_families import (MESHES, check_layers, check_logits,
                                    check_residuals, check_shards,
                                    check_train, check_train_f32,
                                    check_train_world_of_one,
                                    check_world_of_one, make_runs)

FAMILY = dict(
    configs={"xlstm": ("xlstm-125m", {}),
             "xlstm-h2": ("xlstm-125m", dict(n_heads=2, n_kv_heads=2))},
    prompt=30, limits=(0.25, 0.25), tight=3, train="xlstm-h2",
    w_out="w_out")
NAMES = list(FAMILY["configs"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(FAMILY, "test_torch_tp_families_xlstm", tmp_path_factory)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_shards_and_rec_equal_reference_blocks(runs, name, shape):
    check_shards(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_residual_per_layer_near_unsharded_and_reference(runs, name, shape):
    check_residuals(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_logits_within_whole_model_limits(runs, name, shape):
    check_logits(FAMILY, runs, name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_layer_f32_forward_backward_decode(runs, name, shape):
    check_layers(runs, name, shape)


@pytest.mark.parametrize("name", NAMES)
def test_world_of_one_equals_unsharded(runs, name):
    check_world_of_one(runs, name)


def test_train_step_world_of_one_bit_equal(runs):
    check_train_world_of_one(runs)


def test_train_step_near_unsharded_with_control(runs):
    check_train(runs)


def test_train_step_f32_equals_unsharded(runs):
    check_train_f32(runs)
