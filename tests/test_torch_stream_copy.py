"""The port's stream copy (the memory-rate probe's kernel) against the JAX
package's, on the CPU.

The Pallas kernel ``bench.py:_dma_probe._copy_kernel`` is a closure that takes
TPU memory spaces, so it can neither be imported nor run here; the reference
below writes the body's own ``jnp`` lines (bench.py:322-326) per 512-row grid
block, and the step's carry as bench.py:351 takes it.  Everything is integer
arithmetic, so every comparison is exact: the output, the int32 total of the
partial sums (their layout is free), the wrap at the ends of the int8 range,
and chains of dependent steps, one with a sum beyond 2^31 and one with a
negative sum (where ``torch.sum``'s int64 and ``torch.remainder`` would each
give another carry than ``jnp.sum`` and ``lax.rem``).  The ``cuda`` test holds
the CUDA kernel against the plain version on the card and skips without one.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cnn_quantization_tpu_torch.ops.kernels import stream_copy as sc
from cnn_quantization_tpu_torch.utils import counters

TM = 512   # the Pallas grid's row block


def j_copy(a, s):
    """bench.py:322-326 per grid block: (out, per-block column sums)."""
    outs, psums = [], []
    for i in range(0, a.shape[0], TM):
        blk = a[i:i + TM].astype(jnp.int32) + s
        outs.append(blk.astype(jnp.int8))
        psums.append(jnp.sum(blk, axis=0, keepdims=True))
    return jnp.concatenate(outs), jnp.concatenate(psums)


def j_carry(psums):
    return jax.lax.rem(jnp.sum(psums), 2)    # bench.py:351


def _scalar(v):
    return torch.tensor([v], dtype=torch.int32)


def _total(psums):
    return int(psums.sum().to(torch.int32))


@pytest.mark.parametrize('s', [-1, 0, 1, 5])
@pytest.mark.parametrize('shape', [(1024, 256), (1536, 48), (512, 3)])
def test_copy_and_partial_sums_equal_jax(shape, s):
    a = np.random.RandomState(0).randint(-127, 128, shape).astype(np.int8)
    want, want_p = j_copy(jnp.asarray(a), jnp.int32(s))
    got, got_p = sc.stream_copy(torch.from_numpy(a), _scalar(s))
    assert got.dtype == torch.int8 and got_p.dtype == torch.int32 and got_p.ndim == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _total(got_p) == int(jnp.sum(want_p))


def test_wraps_at_both_ends_of_the_range():
    a = np.array([[127, -128, -127, 126, 0, -1]], np.int8)
    for s, expect in ((1, [-128, -127, -126, 127, 1, 0]), (-1, [126, 127, -128, 125, -1, -2])):
        want, want_p = j_copy(jnp.asarray(a), jnp.int32(s))
        got, got_p = sc.stream_copy(torch.from_numpy(a), _scalar(s))
        assert got.numpy().tolist() == [expect] == np.asarray(want).tolist()
        # the sum is taken BEFORE narrowing: 127 + 1 counts as 128
        assert _total(got_p) == int(a.astype(np.int64).sum()) + s * a.size == int(jnp.sum(want_p))


@pytest.mark.parametrize('values', [
    [2 ** 31 - 1, 2 ** 31 - 1, 3],          # true sum 2^32 + 1: int64 fmod gives +1 ...
    [-(2 ** 31), -(2 ** 31), -5],           # ... and here -1; the int32 sums wrap to +1, -5
    [-7], [7], [-4], [0], [2 ** 31 - 1, 1]])
def test_carry_is_rem_of_the_wrapped_int32_sum(values):
    psums = np.array(values, np.int64).astype(np.int32)
    want = int(j_carry(jnp.asarray(psums)))
    got = sc.stream_copy_carry(torch.from_numpy(psums))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1,)
    assert int(got) == want


def _chains(a, steps):
    c_j, s_j = jnp.asarray(a), jnp.int32(0)
    c_t, s_t = torch.from_numpy(a), _scalar(0)
    carries_j, carries_t = [], []
    for _ in range(steps):
        c_j, p_j = j_copy(c_j, s_j)
        s_j = j_carry(p_j)
        c_t, p_t = sc.stream_copy(c_t, s_t)
        s_t = sc.stream_copy_carry(p_t)
        carries_j.append(int(s_j))
        carries_t.append(int(s_t))
    return np.asarray(c_j), c_t.numpy(), carries_j, carries_t


def test_chain_of_dependent_steps_matches_jax():
    a = np.random.RandomState(1).randint(-127, 128, (1024, 64)).astype(np.int8)
    a[0, 0] += 1 if int(a.astype(np.int64).sum()) % 2 == 0 else 0   # an odd sum: carries move
    want, got, carries_j, carries_t = _chains(a, 8)
    assert carries_t == carries_j and set(carries_j) != {0}
    np.testing.assert_array_equal(got, want)


def test_chain_with_a_negative_sum_keeps_the_dividends_sign():
    a = np.full((512, 16), -3, np.int8)
    a[0, 0] = -4                                  # sum -24577: rem -1, floor-mod would be +1
    want, got, carries_j, carries_t = _chains(a, 4)
    assert carries_t == carries_j and carries_j[0] == -1
    np.testing.assert_array_equal(got, want)


def test_chain_whose_sum_crosses_two_to_the_31():
    a = np.full((33 * TM, 1024), 127, np.int8)    # 17.3 M elements: the sum is 2.197e9 > 2^31
    a[0, 0] = 126                                 # odd: the wrapped int32 sum is negative, rem -1
    assert int(a.astype(np.int64).sum()) > 2 ** 31
    want, got, carries_j, carries_t = _chains(a, 2)
    assert carries_t == carries_j and carries_j[0] == -1
    np.testing.assert_array_equal(got, want)


def test_rejects_what_the_kernel_does_not_take():
    before = counters.snapshot()
    a = torch.zeros(4, 4, dtype=torch.int8)
    with pytest.raises(TypeError, match='int8 tensor'):
        sc.stream_copy(a.float(), _scalar(0))
    for bad in (0, torch.zeros(1), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(TypeError, match='one-element int32'):
            sc.stream_copy(a, bad)
    with pytest.raises(ValueError, match='CUDA tensor'):
        sc.launch(a, _scalar(0))
    assert counters.since(before) == {}   # the CPU runs the plain version


@pytest.mark.cuda
def test_stream_copy_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    g = torch.Generator().manual_seed(0)
    for shape in ((4096, 256), (1001, 250), (7, 3)):
        a = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8).cuda()
        for s in (-1, 0, 1):
            sv = torch.full((1,), s, dtype=torch.int32, device='cuda')
            got, got_p = sc.stream_copy(a, sv)
            want, want_p = sc.stream_copy_plain(a, sv)
            assert torch.equal(got, want) and _total(got_p) == _total(want_p)
