"""sparsebench.struct: frozen dataclasses that are JAX pytrees, with static
fields carried in the treedef."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsebench import struct


@struct.dataclass
class Op:
    data: jnp.ndarray
    scale: jnp.ndarray
    n: int = struct.field(pytree_node=False)
    name: str = struct.field(pytree_node=False, default="op")


def _op(n=4, name="op"):
    return Op(data=jnp.arange(n, dtype=jnp.float32), scale=jnp.float32(2.0),
              n=n, name=name)


def test_flatten_unflatten_round_trip():
    op = _op()
    leaves, treedef = jax.tree_util.tree_flatten(op)
    assert len(leaves) == 2  # the static fields are not leaves
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, Op) and back.n == 4 and back.name == "op"
    np.testing.assert_array_equal(back.data, op.data)


@pytest.mark.parametrize("a,b,same", [
    ({"n": 4}, {"n": 4}, True),
    ({"n": 4}, {"n": 5}, False),
    ({"name": "x"}, {"name": "y"}, False),
])
def test_static_fields_are_in_the_treedef(a, b, same):
    ta = jax.tree_util.tree_structure(_op(**a))
    tb = jax.tree_util.tree_structure(_op(**b))
    assert (ta == tb) is same


def test_replace_returns_a_new_frozen_copy():
    op = _op()
    new = op.replace(scale=jnp.float32(3.0))
    assert float(new.scale) == 3.0 and float(op.scale) == 2.0
    assert new.n == op.n
    with pytest.raises(dataclasses.FrozenInstanceError):
        op.n = 7


def test_one_compile_per_static_key():
    traces = []

    @jax.jit
    def apply(op, x):
        traces.append(op.n)
        return op.scale * op.data * x

    x = jnp.float32(1.5)
    for _ in range(3):
        apply(_op(4), x)
    apply(_op(4).replace(scale=jnp.float32(5.0)), x)  # new leaf, same key
    assert traces == [4]
    np.testing.assert_allclose(apply(_op(6), x),
                               2.0 * np.arange(6) * 1.5)
    assert traces == [4, 6]


def test_vmap_over_leaves():
    ops = jax.tree_util.tree_map(lambda *v: jnp.stack(v), _op(), _op())
    out = jax.vmap(lambda o: o.scale * o.data)(ops)
    assert out.shape == (2, 4)
