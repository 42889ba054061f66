from repro_torch.kernels.paged_attention.ops import paged_attention, shard_heads
from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
