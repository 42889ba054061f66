"""granite-4.0-h-small [hybrid] — 40L d_model=4096, 36 Mamba-2 mixers and
4 NoPE GQA attention layers (32H, kv=8, head 128) at layers 5, 15, 25 and
35; every layer's FFN 72 routed SwiGLU experts of 768, top 10, plus one
shared SwiGLU MLP of 1536; vocab=100352, tied embeddings.
[hf:ibm-granite/granite-4.0-h-small, model_type granitemoehybrid]

Mamba-2: 128 heads of 64 (expand 2, d_inner 8192), d_state 128, one B/C
group, conv width 4 with bias, no projection bias, SSD chunk 256.
GraniteMoe's scalars: attention 1/128 (in place of 1/sqrt(128)),
embedding 12, residual 0.22, logits divided by 16; rmsnorm eps 1e-5.

The router keeps the port's grid-snapped top-k (``models/moe.py``); its
gates, the selected probabilities renormalized, equal the published
softmax over the top-10 logits.  ``moe_capacity_factor`` 7.2 = experts /
top-k makes the capacity the whole batch, so no token is dropped, as
published."""
from repro_torch.configs.base import ModelConfig

ATTENTION_AT = (5, 15, 25, 35)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small", family="hybrid",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=768, vocab_size=100352, head_dim=128,
        tie_embeddings=True, rope_theta=1e4,
        num_experts=72, experts_per_token=10, moe_capacity_factor=7.2,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
        conv_width=4, ssm_chunk=256,
        layer_types=tuple("attention" if i in ATTENTION_AT else "mamba"
                          for i in range(40)),
        shared_d_ff=1536,
        attention_multiplier=0.0078125, embedding_multiplier=12.0,
        residual_multiplier=0.22, logits_scaling=16.0,
        rms_norm_eps=1e-5, position_embedding="nope",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=32, vocab_size=256, head_dim=16,
        tie_embeddings=True, rope_theta=1e4,
        num_experts=4, experts_per_token=2, moe_capacity_factor=2.0,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_groups=1,
        conv_width=4, ssm_chunk=16,
        layer_types=("mamba", "attention", "mamba", "mamba"),
        shared_d_ff=48,
        attention_multiplier=0.125, embedding_multiplier=12.0,
        residual_multiplier=0.22, logits_scaling=16.0,
        rms_norm_eps=1e-5, position_embedding="nope",
    )
