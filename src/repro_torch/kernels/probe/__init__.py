from repro_torch.kernels.probe.ops import probe_lookup, resolved_fraction
from repro_torch.kernels.probe.probe import (hash_constants, lookup_bytes,
                                             probe_lookup_kernel)
from repro_torch.kernels.probe.ref import probe_lookup_ref, probe_walk_plain
