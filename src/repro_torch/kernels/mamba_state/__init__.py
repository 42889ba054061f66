from repro_torch.kernels.mamba_state.ops import (mamba_state_kernel,
                                                state_bytes)
from repro_torch.kernels.mamba_state.ref import mamba_state_plain
