"""Architecture registry: --arch <id> resolves here."""
from repro_torch.configs.base import ModelConfig, SACConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME

from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.granite_34b import CONFIG as _granite
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.deepseek_v32_sac import CONFIG as _deepseek

ARCHS = {c.name: c for c in [
    _xlstm, _dbrx, _mixtral, _whisper, _zamba2, _gemma3,
    _qwen2, _minicpm, _granite, _chameleon, _deepseek,
]}

ASSIGNED = [c.name for c in [
    _xlstm, _dbrx, _mixtral, _whisper, _zamba2, _gemma3,
    _qwen2, _minicpm, _granite, _chameleon,
]]


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]
