"""Architecture configs (one module per assigned arch) + registry."""
from __future__ import annotations

import importlib

ARCHS = (
    "zamba2_1p2b",
    "qwen1p5_32b",
    "qwen2p5_32b",
    "gemma3_12b",
    "codeqwen1p5_7b",
    "seamless_m4t_large_v2",
    "granite_moe_1b_a400m",
    "qwen3_moe_235b_a22b",
    "mamba2_2p7b",
    "qwen2_vl_7b",
    "granite_4p0_h_small",
)

# public --arch ids (hyphen/dot form) -> module name
ARCH_IDS = {
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen1.5-32b": "qwen1p5_32b",
    "qwen2.5-32b": "qwen2p5_32b",
    "gemma3-12b": "gemma3_12b",
    "codeqwen1.5-7b": "codeqwen1p5_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "granite-4.0-h-small": "granite_4p0_h_small",
}


def get_config(arch_id: str):
    """Full-size config for an --arch id (or module name)."""
    mod = ARCH_IDS.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{mod}").config()


def get_smoke_config(arch_id: str):
    """Reduced same-family config for CPU smoke tests."""
    mod = ARCH_IDS.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{mod}").smoke_config()
