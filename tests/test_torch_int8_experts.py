"""The int8 serve layout's products in the port against the JAX package on
the CPU: the expert-stacked int8 product (``kernels/int8_experts.py``,
whose plain version the CPU runs) and ragged int8 serve linears, whose
``w8`` the port pads to multiples of 8 once, where the params are made.

- ``int8_experts_matmul`` against ``jax.vmap`` of the int8
  ``dot_general`` at aligned and ragged E, M, K, N: int32-equal.
- ``nn.serve_expert_linear_apply`` of an int8 expert stack against the
  reference's: bit-equal bf16 (the products are exact and the dequant is
  the same f32 arithmetic).
- A ragged int8 linear (K = 100, N = 36): the converted params carry a
  zero-padded ``w8 [104, 40]`` and ``w_step [36]``, and the serve linear
  equals the reference's bit for bit; ``init_serve_linear`` pads alike.
- The wrapper's refusals of malformed operands.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import nn as jnn

from repro_torch import convert
from repro_torch.configs import smoke_config as tsmoke
from repro_torch.kernels import int8_experts as I
from repro_torch.models import nn as tnn

import _torch_families  # noqa: F401  (one torch thread per worker)

SHAPES = [(3, 4, 64, 256), (2, 5, 100, 36), (4, 9, 7, 300), (1, 1, 33, 17)]


def _cfgs():
    over = dict(serve_impl="int8")
    return (dataclasses.replace(jsmoke("deepseek-v3-671b"), **over),
            dataclasses.replace(tsmoke("deepseek-v3-671b"), **over))


@pytest.mark.parametrize("E,M,K,N", SHAPES)
def test_int8_experts_plain_equals_jax(E, M, K, N):
    rng = np.random.default_rng(E * 1000 + K)
    a = rng.integers(-127, 128, (E, M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (E, K, N)).astype(np.int8)
    want = np.asarray(jax.vmap(lambda x, y: jax.lax.dot_general(
        x, y, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))(a, w))
    got = I.int8_experts_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert I.launches == 0                     # the CPU runs the plain twin


@pytest.mark.parametrize("K,N", [(64, 32), (100, 36)])
def test_int8_expert_linear_equals_jax(K, N):
    jcfg, tcfg = _cfgs()
    E, G, cap = 4, 2, 3
    p, _ = jnn.init_serve_linear(jax.random.PRNGKey(1), K, N, jcfg, expert=E)
    p = dict(p, a_step=jnp.full((E,), 1 / 32, jnp.float32),
             w_step=jnp.full((E, N), 3 / (127 * np.sqrt(K)), jnp.float32))
    tp = convert.params_from_jax({"lin": jax.tree.map(np.asarray, p)},
                                 "cpu").tree()["lin"]
    assert tp["w8"].shape == (E, -(-K // 8) * 8, -(-N // 8) * 8)
    rng = np.random.default_rng(K)
    xe = jnp.asarray(rng.standard_normal((G, E, cap, K)), jnp.bfloat16)
    want = np.asarray(jax.jit(lambda pp, x: jnn.serve_expert_linear_apply(
        pp, x, jcfg))(p, xe), np.float32)
    got = tnn.serve_expert_linear_apply(
        tp, convert.to_torch(np.asarray(xe), "cpu"), tcfg)
    assert got.shape == (G, E, cap, N)
    assert np.array_equal(got.float().numpy(), want)


def test_ragged_int8_linear_padded_equals_jax():
    jcfg, tcfg = _cfgs()
    K, N = 100, 36
    p, _ = jnn.init_serve_linear(jax.random.PRNGKey(2), K, N, jcfg)
    p = dict(p, a_step=jnp.float32(1 / 32),
             w_step=jnp.full((N,), 3 / (127 * np.sqrt(K)), jnp.float32))
    tp = convert.params_from_jax({"lin": jax.tree.map(np.asarray, p)},
                                 "cpu").tree()["lin"]
    assert tuple(tp["w8"].shape) == (104, 40)
    assert tuple(tp["w_step"].shape) == (N,)
    w8 = tp["w8"].numpy()
    assert np.array_equal(w8[:K, :N], np.asarray(p["w8"]))
    assert not w8[K:].any() and not w8[:, N:].any()
    x = jnp.asarray(np.random.default_rng(5).standard_normal((3, 5, K)),
                    jnp.bfloat16)
    want = np.asarray(jax.jit(lambda pp, xx: jnn.serve_linear_apply(
        pp, xx, jcfg))(p, x), np.float32)
    got = tnn.serve_linear_apply(tp, convert.to_torch(np.asarray(x), "cpu"),
                                 tcfg)
    assert got.shape == (3, 5, N)
    assert np.array_equal(got.float().numpy(), want)
    gen = torch.Generator().manual_seed(0)
    fresh = tnn.init_serve_linear(gen, K, N, tcfg, device="cpu")
    assert tuple(fresh["w8"].shape) == (104, 40)
    assert not fresh["w8"][K:].any() and not fresh["w8"][:, N:].any()
    assert tuple(fresh["w_step"].shape) == (N,)


def test_int8_experts_refusals():
    a = torch.zeros((2, 3, 8), dtype=torch.int8)
    w = torch.zeros((2, 8, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        I.int8_experts_matmul(a.int(), w)
    with pytest.raises(ValueError, match="chain"):
        I.int8_experts_matmul(a, w[:, :4])
    with pytest.raises(ValueError, match="chain"):
        I.int8_experts_matmul(a[:1], w)
    with pytest.raises(ValueError, match=r"\[E, K, N\]"):
        I.int8_experts_matmul(a, w[0])
