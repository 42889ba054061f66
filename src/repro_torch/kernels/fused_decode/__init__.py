from repro_torch.kernels.fused_decode.fused import fused_decode_kernel
from repro_torch.kernels.fused_decode.ops import (fused_paged_attention,
                                                  merge_fused_partials)
from repro_torch.kernels.fused_decode.ref import (block_table_slots_ref,
                                                  fused_decode_plain,
                                                  fused_decode_ref,
                                                  merge_split_partials)
