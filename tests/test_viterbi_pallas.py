"""Triton-route Pallas Viterbi kernel vs the XLA scan reference.

On the CPU the kernel runs in Pallas interpret mode; the compiled kernel
is compared with the scan on the card by the `gpu`-marked test (run by
chip_smoke.py). Every case must be bit-identical: the kernel's metrics
are exact integer sums and its tie rules are the scan's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tetra_tpu.constants import CONV_GENERATORS_CCH, CONV_GENERATORS_TCH
from tetra_tpu.lmac import fused
from tetra_tpu.ops import rcpc, viterbi
from tetra_tpu.ops.viterbi_pallas import decode_pallas

CCH = tuple(map(tuple, CONV_GENERATORS_CCH))
TCH = tuple(map(tuple, CONV_GENERATORS_TCH))


def _soft(kind, rng, B, n_sym, n):
    """Soft mother-bit batches of the alphabets the pipeline feeds."""
    if kind == "hard":          # hard slicer after assembly: ±127 / 0
        v = rng.integers(-1, 2, size=(B, n_sym * n)) * 127
    elif kind == "soft":        # soft demod reliabilities times 127
        v = rng.integers(-31, 32, size=(B, n_sym * n)) * 127
    elif kind == "ties":        # ±1/0: many exactly tied path metrics
        v = rng.integers(-1, 2, size=(B, n_sym * n))
    else:                       # all erasures: every metric ties
        v = np.zeros((B, n_sym * n))
    return jnp.asarray(v.astype(np.float32))


def _kernel(soft, n_sym, gens=CCH, rmask=None, boundaries=(), rows=16):
    return np.asarray(decode_pallas(soft, n_sym, gens, rmask, boundaries,
                                    block_rows=rows, interpret=True))


class TestKernelVsScan:
    @pytest.mark.parametrize("kind", ["hard", "soft", "ties", "erasures"])
    def test_alphabets(self, kind):
        rng = np.random.default_rng(len(kind))
        soft = _soft(kind, rng, 32, 80, 4)
        np.testing.assert_array_equal(_kernel(soft, 80),
                                      np.asarray(viterbi.decode(soft, 80)))

    @pytest.mark.parametrize("B", [1, 5, 17, 40])
    def test_partial_block(self, B):
        """Batches that do not fill a block pad and unpad cleanly."""
        rng = np.random.default_rng(B)
        soft = _soft("hard", rng, B, 72, 4)
        out = _kernel(soft, 72)
        assert out.shape == (B, 72) and out.dtype == np.int8
        np.testing.assert_array_equal(out,
                                      np.asarray(viterbi.decode(soft, 72)))

    def test_longer_input_is_truncated(self):
        """Inputs longer than n_sym*N decode their first n_sym steps."""
        rng = np.random.default_rng(3)
        soft = _soft("soft", rng, 8, 100, 4)
        np.testing.assert_array_equal(_kernel(soft, 80),
                                      np.asarray(viterbi.decode(soft, 80)))

    @pytest.mark.parametrize("kind", ["hard", "soft"])
    def test_tch_generators(self, kind):
        rng = np.random.default_rng(4)
        soft = _soft(kind, rng, 24, 72, 3)
        np.testing.assert_array_equal(
            _kernel(soft, 72, TCH), np.asarray(viterbi.decode(soft, 72, TCH)))

    def test_tch_roundtrip(self):
        rng = np.random.default_rng(5)
        data = rng.integers(0, 2, size=(8, 72)).astype(np.int8)
        data[:, -4:] = 0
        mother = rcpc.conv_encode(jnp.asarray(data), CONV_GENERATORS_TCH)
        soft = jnp.asarray((1.0 - 2.0 * np.asarray(mother)) * 127.0)
        np.testing.assert_array_equal(_kernel(soft, 72, TCH), data)

    def test_cch_roundtrip(self):
        rng = np.random.default_rng(6)
        data = rng.integers(0, 2, size=(16, 80)).astype(np.int8)
        data[:, -4:] = 0
        mother = rcpc.conv_encode(jnp.asarray(data))
        soft = jnp.asarray((1.0 - 2.0 * np.asarray(mother)) * 127.0)
        np.testing.assert_array_equal(_kernel(soft, 80), data)


class TestSegmentRestarts:
    @pytest.mark.parametrize("kind", ["hard", "soft", "ties"])
    def test_random_restarts(self, kind):
        """Unified 288-step trellis with random per-row restart masks at
        the fused path's boundaries == the segmented scan."""
        rng = np.random.default_rng(20 + len(kind))
        soft = _soft(kind, rng, 40, fused.N_SYM, 4)
        rm = jnp.asarray(rng.integers(0, 2, size=(40, 3)).astype(np.float32))
        want = np.asarray(fused.decode_segmented(soft, rm))
        np.testing.assert_array_equal(
            _kernel(soft, fused.N_SYM, CCH, rm, fused.BOUNDARIES), want)

    def test_kind_layouts_vs_independent_blocks(self):
        """Each restart layout (SYNC 80+144+pad, SCH/F, NDB 144+144)
        decodes exactly as independent per-segment decodes."""
        rng = np.random.default_rng(7)
        layouts = [(80, 144, 64), (288,), (144, 144), (80, 64, 80, 64)]
        soft = np.asarray(_soft("hard", rng, len(layouts), 288, 4))
        rm = np.zeros((len(layouts), 3), np.float32)
        want = np.zeros((len(layouts), 288), np.int8)
        for i, segs in enumerate(layouts):
            t = 0
            for n in segs:
                if t:
                    rm[i, fused.BOUNDARIES.index(t)] = 1
                want[i, t:t + n] = np.asarray(viterbi.decode(
                    jnp.asarray(soft[i:i + 1, 4 * t:4 * (t + n)]), n))[0]
                t += n
        got = _kernel(jnp.asarray(soft), 288, CCH, jnp.asarray(rm),
                      fused.BOUNDARIES)
        np.testing.assert_array_equal(got, want)


class TestSelectionPoint:
    """viterbi.decode_fast picks the kernel per lowering platform."""

    def _lowered(self, platform):
        soft = jnp.zeros((8, fused.N_MOTHER), jnp.float32)
        rm = jnp.zeros((8, 3), jnp.float32)
        f = jax.jit(lambda s, r: viterbi.decode_fast(
            s, fused.N_SYM, rmask=r, boundaries=fused.BOUNDARIES))
        return f.trace(soft, rm).lower(
            lowering_platforms=(platform,)).as_text()

    def test_cpu_runs_the_scan(self):
        assert "triton" not in self._lowered("cpu").lower()

    def test_cuda_runs_the_kernel(self):
        """Lowering for an NVIDIA GPU (done here without one) emits the
        Triton kernel call, so the Triton lowering itself is checked."""
        assert "triton" in self._lowered("cuda").lower()

    def test_cpu_result_matches_scan(self):
        rng = np.random.default_rng(8)
        soft = _soft("hard", rng, 12, fused.N_SYM, 4)
        rm = jnp.asarray(rng.integers(0, 2, size=(12, 3)).astype(np.float32))
        got = viterbi.decode_fast(soft, fused.N_SYM, rmask=rm,
                                  boundaries=fused.BOUNDARIES)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(fused.decode_segmented(soft, rm)))


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    """The compiled kernel on the card == the scan on the CPU, at the
    1024-carrier chunk's row count."""
    rng = np.random.default_rng(9)
    soft = _soft("soft", rng, 20_000, fused.N_SYM, 4)
    rm = jnp.asarray(rng.integers(0, 2, size=(20_000, 3)).astype(np.float32))
    got = decode_pallas(jax.device_put(soft, gpu), fused.N_SYM, CCH,
                        jax.device_put(rm, gpu), fused.BOUNDARIES)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        want = fused.decode_segmented(jax.device_put(soft, cpu),
                                      jax.device_put(rm, cpu))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
