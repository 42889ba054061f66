"""Hand-written Hopper kernels for the three Pallas kernels of the JAX
package, and one for the mamba state update of a decode token, each
beside its plain PyTorch version."""
