"""Hand-written Hopper kernels for the three Pallas kernels of the JAX
package, each beside its plain PyTorch version."""
