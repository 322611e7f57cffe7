"""The K2/K3 half-sweep kernels (``csrc/stencil.cu``) on the CPU:
``ref.rb_dilu_pairs`` walks the kernel's k-pairs in plain torch (the
pair's first swept cell's face sum, a second one only when both cells are
swept, faces outside the domain skipped).  It must equal the plain version
(``ref.rb_dilu_forward``/``rb_dilu_backward``) bit for bit, under the
grid's checkerboard and under any mask, and agree with the JAX package's
Pallas kernels (interpret mode) within the stencil tolerance of
tests/test_kernels.py (rtol=3e-4, atol=1e-4).  Also: the C entries'
argument counts match ``build.ENTRIES``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import fvm as jfvm
from repro.cfd.grid import Grid as JGrid
from repro.cfd.precond import rb_dilu_factor as j_rb_dilu_factor
from repro.kernels.stencil_spmv import kernel as JS
from repro_torch.kernels import build
from repro_torch.kernels.stencil_spmv import ref as SR

# (37, 29, 23) and (5, 7, 3): odd nz, so a row's last cell has no partner
# and the pairs of neighbouring rows start on cells of both colours;
# (1, 3, 2): one plane, one pair a row; (11, 18, 70): longer rows
SHAPES = [(37, 29, 23), (5, 7, 3), (1, 3, 2), (11, 18, 70)]
HALF_SWEEPS = {"rb_dilu_forward": True, "rb_dilu_backward": False}


def _random_inputs(shape, mask, seed=0):
    rng = np.random.RandomState(seed)
    rdiag = torch.from_numpy(rng.rand(*shape).astype(np.float32) + 0.5)
    off = torch.from_numpy(rng.rand(6, *shape).astype(np.float32) - 0.5)
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    if mask == "checkerboard":
        i, j, k = np.indices(shape)
        red = (i + j + k) % 2 == 0
    else:
        red = rng.rand(*shape) < 0.5
    return rdiag, torch.from_numpy(red), off, x


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("mask", ["checkerboard", "random", "all_swept"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(HALF_SWEEPS))
def test_twin_equals_plain_version(name, shape, mask):
    """``all_swept``: every cell of every pair is swept (no red cell for
    K2, no black one for K3), so each pair takes both face sums."""
    rdiag, red, off, x = _random_inputs(
        shape, "random" if mask == "all_swept" else mask)
    if mask == "all_swept":
        red = torch.full_like(red, not HALF_SWEEPS[name])
    got = SR.rb_dilu_pairs(rdiag, red, off, x, forward=HALF_SWEEPS[name])
    want = getattr(SR, name)(rdiag, red, off, x)
    assert torch.equal(_bits(got), _bits(want))


def _stencil_inputs(shape, mask, seed):
    """The JAX package's Laplacian and its red-black DILU factor."""
    g = JGrid(shape)
    A, _ = jfvm.laplacian(g, 1.0)
    if mask == "checkerboard":
        red = np.array(g.red_black_masks()[0])
    else:
        red = np.random.RandomState(seed).rand(*shape) < 0.5
    P = j_rb_dilu_factor(A, jnp.asarray(red))
    r = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return np.array(P.rdiag), red, np.array(A.off), r


@pytest.mark.parametrize("mask", ["checkerboard", "random"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["rb_dilu_forward", "rb_dilu_backward",
                                    "rb_dilu"])
def test_twin_matches_pallas(kernel, shape, mask):
    rdiag, red, off, r = _stencil_inputs(shape, mask, seed=len(kernel))
    want = getattr(JS, kernel)(jnp.asarray(rdiag), jnp.asarray(red),
                               jnp.asarray(off), jnp.asarray(r))
    t = [torch.from_numpy(a) for a in (rdiag, red, off, r)]
    if kernel == "rb_dilu":
        y = SR.rb_dilu_pairs(*t, forward=True)
        got = SR.rb_dilu_pairs(*t[:3], y, forward=False)
    else:
        got = SR.rb_dilu_pairs(*t, forward=HALF_SWEEPS[kernel])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=1e-4)


def test_entries_match_the_c_signatures():
    """Every C entry of csrc/*.cu takes as many pointers and ints as
    ``build.ENTRIES`` binds, then the stream."""
    found = {}
    for src in build.sources():
        text = src.read_text().split('extern "C" {', 1)[1]
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", text, re.M):
            kinds = [p.strip() for p in params.split(",")]
            assert kinds[-1].startswith("cudaStream_t")
            found[name] = (sum("*" in p for p in kinds[:-1]),
                           sum(p.startswith("int ") for p in kinds[:-1]))
    assert found == build.ENTRIES
