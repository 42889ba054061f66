"""The JAX package's table operations as the port's tests call them: each
through ``jax.jit`` with its Python options static.  Called eagerly, the
reference dispatches op by op, seconds a call on the CPU; a test that
loops over them, or a property test over many examples, calls them from
here, so that which arguments are static is said once."""
import functools
import types

import jax

from repro.core import batched as JBT
from repro.core.probe_strategies import get_strategy
from repro.serving import page_table as JPT

apply_batch = jax.jit(JBT.apply_batch, static_argnames="strategy")


@functools.cache
def strategy(name: str) -> types.SimpleNamespace:
    """``insert_batch`` and ``delete_batch`` of the reference's strategy."""
    impl = get_strategy(name)
    return types.SimpleNamespace(insert_batch=jax.jit(impl.insert_batch),
                                 delete_batch=jax.jit(impl.delete_batch))


@functools.cache
def page_table(name: str) -> types.SimpleNamespace:
    """``alloc_step_incremental`` and ``free_sequences`` of the reference's
    page-table facade for strategy ``name``."""
    pt = JPT.for_strategy(name)
    return types.SimpleNamespace(
        alloc_step_incremental=jax.jit(pt.alloc_step_incremental,
                                       static_argnames="page_size"),
        free_sequences=jax.jit(pt.free_sequences,
                               static_argnames=("page_size", "max_pages")))
