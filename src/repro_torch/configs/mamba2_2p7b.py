"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2·2560 = 5120; ssm head_dim 64 ⇒ 80 value heads (80 = 16·5, sharding
cleanly over the model axis); 1 B/C group (ngroups=1 in the paper's 2.7b).
Constant-size recurrent state ⇒ long_500k decode is O(1)/token."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        conv_width=4, ssm_chunk=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256,
        tie_embeddings=True,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
        conv_width=4, ssm_chunk=32,
    )
