"""The port's fused s8 matmul + requant (kernel K2's plain version) against
the JAX package: bit-exact to ``matmul_s8_requant_reference`` and to the
Pallas kernel in interpret mode.  Inputs are drawn from a numpy seed with
the JAX test's distributions (the wrapper's CPU path is checked in
``test_torch_imports.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.ops.matmul_s8 import matmul_s8_requant as jax_kernel
from enhance_cb_whisper_tpu.ops.matmul_s8 import matmul_s8_requant_reference as jax_reference
from enhance_cb_whisper_tpu_torch.ops.matmul_s8 import matmul_s8_requant_plain


def _case(seed, m, k, n, residual):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, (n,)) * 1e-4).astype(np.float32)
    bias = rng.normal(0, 0.5, (n,)).astype(np.float32)
    res = {}
    if residual == "vector":
        res = dict(residual=rng.integers(-127, 128, (m, n)).astype(np.int8),
                   res_scale=(rng.uniform(0.5, 2.0, (n,)) * 1e-3).astype(np.float32))
    elif residual == "scalar":
        res = dict(residual=rng.integers(-127, 128, (m, n)).astype(np.int8),
                   res_scale=np.float32(rng.uniform(0.5, 2.0) * 1e-3))
    return (x, w, scale, bias), res


def _port(args, res, relu):
    t = [torch.from_numpy(a) for a in args]
    kw = {}
    if res:
        kw = dict(residual=torch.from_numpy(res["residual"]),
                  res_scale=torch.as_tensor(res["res_scale"]))
    return matmul_s8_requant_plain(*t, relu=relu, **kw).numpy()


def _jax(fn, args, res, relu, **extra):
    j = [jnp.asarray(a) for a in args]
    kw = {k: jnp.asarray(v) for k, v in res.items()}
    return np.asarray(fn(*j, relu=relu, **kw, **extra))


@pytest.mark.parametrize("residual", [None, "vector", "scalar"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("k,n", [(128, 128), (256, 128), (128, 256)])
def test_plain_bit_exact_to_reference_and_interpret_kernel(k, n, relu, residual):
    args, res = _case(k + n, 256, k, n, residual)
    got = _port(args, res, relu)
    np.testing.assert_array_equal(got, _jax(jax_reference, args, res, relu))
    np.testing.assert_array_equal(
        got, _jax(jax_kernel, args, res, relu, block_m=128, interpret=True)
    )
    assert len(np.unique(got)) > 10  # the codes are not trivially constant


@pytest.mark.parametrize("residual", [None, "vector"])
def test_plain_bit_exact_at_ragged_m(residual):
    """M not a multiple of 8: the JAX reference (its kernel wants M % 8)."""
    args, res = _case(5, 61, 128, 128, residual)
    np.testing.assert_array_equal(_port(args, res, True), _jax(jax_reference, args, res, True))



# K2's launch planner (pure Python): the 9 shapes of an int8 ResNet-50 chunk
# at 150x750 and ragged M for each plan kind
_MAIN_PATH_SHAPES = [
    (57152, 256, 128), (14288, 512, 128), (14288, 128, 512), (14288, 512, 256), (3760, 1024, 256),
    (3760, 256, 1024), (3760, 1024, 512), (960, 2048, 512), (960, 512, 2048),
]
_RAGGED_SHAPES = [(1, 2048, 512), (961, 2048, 512), (3761, 1024, 256), (14293, 512, 128), (14293, 128, 512)]


@pytest.mark.parametrize("m,k,n", _MAIN_PATH_SHAPES + _RAGGED_SHAPES)
def test_launch_plan_covers_the_output_and_partitions_k(m, k, n):
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda as k2

    plan = k2.launch_plan(m, k, n)
    assert plan.bm in (64, 128) and n % k2.BN == 0
    m_tiles = -(-m // plan.bm)
    assert m_tiles * plan.bm >= m > (m_tiles - 1) * plan.bm  # the tiles cover M, none is empty
    assert plan.tiles == m_tiles * (n // k2.BN) and plan.ctas == plan.tiles * plan.split >= 1
    slices = plan.k_slices()
    assert len(slices) == plan.split <= k2.MAX_SPLIT
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(k0 < k1 and k0 % 128 == 0 and k1 % 128 == 0 for k0, k1 in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    # BM = 128 only where it still fills the SMs and a tile has 2+ k-tiles
    if plan.bm == 128:
        assert plan.tiles >= k2.NUM_SMS and k >= 256
    # K is split only where the tiles leave more than half the SMs idle,
    # and no further than needed to fill half
    if plan.split > 1:
        assert 2 * plan.tiles < k2.NUM_SMS
        assert 2 * plan.tiles * (plan.split // 2) < k2.NUM_SMS


@pytest.mark.parametrize("m,k,n", [(960, 192, 128), (960, 128, 192), (960, 64, 256), (960, 256, 64)])
def test_launch_plan_rejects_k_or_n_not_a_multiple_of_128(m, k, n):
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda as k2

    with pytest.raises(ValueError, match="128"):
        k2.launch_plan(m, k, n)
