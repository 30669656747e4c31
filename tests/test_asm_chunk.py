"""Chunked element assembly (forms/navier_stokes.py::_map_in_chunks).

Large meshes (the ~950k-DOF DFG run at 631k cells) need large compile
temporaries when the cell kernel is vmapped over the full mesh: the
jacfwd temps are rank-5 with two tiny minor dims. Chunking bounds those
temps. These tests pin that the chunked path matches the
single-vmap path to rounding (XLA fuses the two paths differently, so
~1e-17 reassociation noise is expected) for both the residual and the
element Jacobians (incl. facet terms on the un-chunked boundary path).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cfdtpu.forms import StabilizedNSForm
from cfdtpu.forms.facet_terms import weak_pressure
from cfdtpu.mesh import create_unit_square
from cfdtpu.spaces import FunctionSpace


def _setup():
    mesh = create_unit_square(7, 7)  # 98 cells: 3+ chunks at chunk=32
    V = FunctionSpace(mesh, 1, 2)
    Q = FunctionSpace(mesh, 1)
    form = StabilizedNSForm(V, Q)
    tags = np.arange(len(mesh.facets), dtype=np.int32)
    form.add_facet_term("weak_pressure", tags[:6], weak_pressure("p_in", 1.0))
    rng = np.random.RandomState(11)
    u = jnp.asarray(rng.randn(V.num_dofs, 2))
    p = jnp.asarray(rng.randn(Q.num_dofs))
    prm = {
        "dt": jnp.asarray(0.01), "rho": jnp.asarray(1.0),
        "mu": jnp.asarray(0.01), "f": jnp.zeros(2),
        "p_in": jnp.asarray(2.0),
    }
    return form, u, p, prm


def test_chunked_assembly_matches_single_vmap(monkeypatch):
    form, u, p, prm = _setup()

    monkeypatch.setenv("CFDTPU_ASM_CHUNK", "0")
    ru0, rp0 = form.residual(u, p, (u,), prm)
    A0, B0 = form.element_jacobians(u, p, (u,), prm)

    monkeypatch.setenv("CFDTPU_ASM_CHUNK", "32")
    ru1, rp1 = form.residual(u, p, (u,), prm)
    A1, B1 = form.element_jacobians(u, p, (u,), prm)

    assert np.allclose(np.asarray(ru0), np.asarray(ru1), atol=1e-13, rtol=0)
    assert np.allclose(np.asarray(rp0), np.asarray(rp1), atol=1e-13, rtol=0)
    assert np.allclose(np.asarray(A0), np.asarray(A1), atol=1e-12, rtol=0)
    assert len(B0) == len(B1) and B0
    for (_, b0), (_, b1) in zip(B0, B1):
        assert np.allclose(np.asarray(b0), np.asarray(b1),
                           atol=1e-12, rtol=0)


def test_chunk_gate_thresholds(monkeypatch):
    """Meshes at or below 2 chunks keep the single-vmap HLO (cache-valid
    for the 106k bench executable); larger meshes chunk; 0 disables."""
    from cfdtpu.forms.navier_stokes import _asm_chunk

    monkeypatch.setenv("CFDTPU_ASM_CHUNK", "65536")
    assert _asm_chunk(131072) == 0
    assert _asm_chunk(131073) == 65536
    monkeypatch.setenv("CFDTPU_ASM_CHUNK", "0")
    assert _asm_chunk(10**9) == 0


def test_chunk_padding_edge(monkeypatch):
    """nc not divisible by chunk: padded tail must not leak into results."""
    form, u, p, prm = _setup()  # 98 cells, chunk 24 -> k=5, pad=22
    monkeypatch.setenv("CFDTPU_ASM_CHUNK", "0")
    ru0, rp0 = form.residual(u, p, (u,), prm)
    monkeypatch.setenv("CFDTPU_ASM_CHUNK", "24")
    ru1, rp1 = form.residual(u, p, (u,), prm)
    assert np.allclose(np.asarray(ru0), np.asarray(ru1), atol=1e-13, rtol=0)
    assert np.allclose(np.asarray(rp0), np.asarray(rp1), atol=1e-13, rtol=0)
