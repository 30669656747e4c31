"""Distributed assembly: shard_map over mesh partitions.

Replaces the reference's MPI domain decomposition (implicit in dolfinx:
every function space has a parallel index_map with ghosts, SURVEY.md §2.9;
ghost updates at /root/reference/src/solvers/stabilized_schur.py:137-142,168,175,
allreduce at src/scenario.py:272-281). Design, stage 1:

- **Element-sharded, dof-replicated**: cells (the FLOP-heavy element
  kernels) are partitioned across devices; each device scatter-adds its
  partition's contributions into a full-length residual and a single
  psum over the mesh axis replaces both the REVERSE (ghost-accumulate)
  and FORWARD (owner-broadcast) ghost updates in one collective.
- Krylov vector algebra runs replicated (identical on all devices), so
  dot products need no extra collectives.

This keeps the whole Newton-Krylov step valid under shard_map/jit for any
device count; dof-partitioned halos (ppermute exchange) are the follow-up
optimization for very large meshes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as P
from jax import shard_map

from ..forms import StabilizedNSForm


def make_device_mesh(n_devices: int | None = None,
                     axis_name: str = "cells") -> DeviceMesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    return DeviceMesh(np.array(devs[:n]), (axis_name,))


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


class ShardedNSForm:
    """Wraps a StabilizedNSForm with a cell-sharded residual.

    Same `residual`/`diagonal` interface as StabilizedNSForm, so solvers
    swap it in transparently. Cells are padded to a multiple of the device
    count; padded duplicates are masked out of the scatter.
    """

    def __init__(self, form: StabilizedNSForm, device_mesh: DeviceMesh):
        self.inner = form
        self.device_mesh = device_mesh
        self.V, self.Q = form.V, form.Q
        self.mesh = form.mesh
        self.dim = form.dim
        self.dtype = form.dtype

        nd = device_mesh.devices.size
        nc = form.mesh.num_cells
        nc_pad = ((nc + nd - 1) // nd) * nd

        dm_u = np.asarray(form.dofmap_u)
        dm_p = np.asarray(form.dofmap_p)
        cc = np.asarray(form.cell_coords)
        hh = np.asarray(form.cell_h)
        mask = np.zeros(nc_pad, dtype=np.asarray(cc).dtype)
        mask[:nc] = 1.0

        self.dofmap_u = jnp.asarray(_pad_to(dm_u, nc_pad))
        self.dofmap_p = jnp.asarray(_pad_to(dm_p, nc_pad))
        self.cell_coords = jnp.asarray(_pad_to(cc, nc_pad))
        self.cell_h = jnp.asarray(_pad_to(hh, nc_pad))
        self.cell_mask = jnp.asarray(mask)

        # keep the serial form's auxiliary API (l2_norm_sq etc.)
        self.l2_norm_sq = form.l2_norm_sq

        self.dofmap_flat = jnp.asarray(
            _pad_to(form._dmf_np, nc_pad).astype(np.int32)
        )
        self.nloc = form.nloc
        self.n_flat = form.n_flat

        self._residual_sharded = self._build_residual()
        self._jacobians_sharded = self._build_jacobians()
        self._apply_sharded = self._build_apply()

    def _build_residual(self):
        form = self.inner
        kernel = form._kernel
        n_u, n_p, dim = self.V.num_dofs, self.Q.num_dofs, self.dim
        dtype = self.dtype

        def local(u, p, aux, dm_u, dm_p, cc, hh, mask, prm):
            aux_e = tuple(a[dm_u] for a in aux)
            ru_e, rp_e = jax.vmap(
                kernel, in_axes=(0, 0, 0, 0, 0, None)
            )(u[dm_u], p[dm_p], aux_e, cc, hh, prm)
            ru_e = ru_e * mask[:, None, None]
            rp_e = rp_e * mask[:, None]
            ru = jnp.zeros((n_u, dim), dtype).at[dm_u].add(ru_e)
            rp = jnp.zeros((n_p,), dtype).at[dm_p].add(rp_e)
            ru = jax.lax.psum(ru, "cells")
            rp = jax.lax.psum(rp, "cells")
            return ru, rp

        sharded = shard_map(
            local,
            mesh=self.device_mesh,
            in_specs=(
                P(), P(), P(),
                P("cells"), P("cells"), P("cells"), P("cells"), P("cells"),
                P(),
            ),
            out_specs=(P(), P()),
        )

        def residual(u, p, aux, prm):
            ru, rp = sharded(
                u, p, aux,
                self.dofmap_u, self.dofmap_p,
                self.cell_coords, self.cell_h, self.cell_mask, prm,
            )
            for block in form._facet_blocks:
                dm_u, ru_f = form._block_residual(block, u, p, aux, prm)
                ru = ru.at[dm_u].add(ru_f)
            return ru, rp

        return residual

    def residual(self, u, p, aux, prm):
        return self._residual_sharded(u, p, aux, prm)

    # ------------------------------------------------------------------
    # Sharded Jacobian build + application: the element Jacobian blocks
    # live SHARDED over the cell axis for their whole lifetime (built by
    # jacfwd on each device's cell partition, consumed by the sharded
    # matvec); only the assembled global vectors are psum-replicated.
    # ------------------------------------------------------------------
    def _build_jacobians(self):
        form = self.inner
        nbu = self.V.element.ndofs
        dim = self.dim
        fk = form._flat_cell_kernel()

        def local(u, p, aux, dm_u, dm_p, cc, hh, prm):
            xe = jnp.concatenate(
                [u[dm_u].reshape(dm_u.shape[0], -1), p[dm_p]], axis=1
            )
            aux_e = tuple(a[dm_u] for a in aux)
            return jax.vmap(
                jax.jacfwd(fk), in_axes=(0, 0, 0, 0, None)
            )(xe, aux_e, cc, hh, prm)

        return shard_map(
            local,
            mesh=self.device_mesh,
            in_specs=(
                P(), P(), P(),
                P("cells"), P("cells"), P("cells"), P("cells"), P(),
            ),
            out_specs=P("cells"),
        )

    def element_jacobians(self, u, p, aux, prm):
        A_cells = self._jacobians_sharded(
            u, p, aux, self.dofmap_u, self.dofmap_p,
            self.cell_coords, self.cell_h, prm,
        )
        # facet blocks are small; build replicated via the serial form
        form = self.inner
        A_blocks = []
        for block in form._facet_blocks:
            dm_u = block["dofmap_u"]
            dm_p = block["dofmap_p"]
            xef = jnp.concatenate(
                [u[dm_u].reshape(dm_u.shape[0], -1), p[dm_p]], axis=1
            )
            aux_ef = tuple(a[dm_u] for a in aux)
            ffk = form._flat_facet_kernel(block["kernel"])
            A_f = jax.vmap(
                jax.jacfwd(ffk), in_axes=(0, 0, 0, 0, None)
            )(xef, aux_ef, block["coords"], block["tabs"], prm)
            A_blocks.append((block["dofmap_flat"], A_f))
        return A_cells, A_blocks

    def _build_apply(self):
        n_flat = self.n_flat
        dtype = self.dtype

        def local(A, dmf, mask, v):
            ve = v[dmf]
            ye = jnp.einsum("cab,cb->ca", A, ve) * mask[:, None]
            y = jnp.zeros((n_flat,), dtype).at[dmf].add(ye)
            return jax.lax.psum(y, "cells")

        return shard_map(
            local,
            mesh=self.device_mesh,
            in_specs=(P("cells"), P("cells"), P("cells"), P()),
            out_specs=P(),
        )

    def apply_element_matrices(self, A_cells, A_blocks, v_flat):
        y = self._apply_sharded(
            A_cells, self.dofmap_flat, self.cell_mask, v_flat
        )
        for dmf, A_f in A_blocks:
            vf = v_flat[dmf]
            yf = jnp.einsum("fab,fb->fa", A_f, vf)
            y = y.at[dmf].add(yf)
        return y

    def jacobian_diagonal(self, A_cells, A_blocks):
        idx = jnp.arange(self.nloc)
        diag_e = A_cells[:, idx, idx]
        y = self._apply_diag(diag_e)
        for dmf, A_f in A_blocks:
            y = y.at[dmf].add(A_f[:, idx, idx])
        return y

    def _apply_diag(self, diag_e):
        n_flat = self.n_flat
        dtype = self.dtype

        def local(d, dmf, mask):
            y = jnp.zeros((n_flat,), dtype).at[dmf].add(
                d * mask[:, None]
            )
            return jax.lax.psum(y, "cells")

        return shard_map(
            local,
            mesh=self.device_mesh,
            in_specs=(P("cells"), P("cells"), P("cells")),
            out_specs=P(),
        )(diag_e, self.dofmap_flat, self.cell_mask)

    def apply_sub_block(self, A_cells, A_blocks, v, which: str):
        form = self.inner
        nud = self.V.element.ndofs * self.dim
        row_u = which[0] == "u"
        col_u = which[1] == "u"
        rs = slice(0, nud) if row_u else slice(nud, self.nloc)
        cs = slice(0, nud) if col_u else slice(nud, self.nloc)
        n_u_flat = form.n_u_flat
        n_out = n_u_flat if row_u else self.Q.num_dofs
        dtype = self.dtype

        dm_col = (
            self.dofmap_flat[:, cs]
            if col_u else self.dofmap_flat[:, cs] - n_u_flat
        )
        dm_row = (
            self.dofmap_flat[:, rs]
            if row_u else self.dofmap_flat[:, rs] - n_u_flat
        )

        def local(A, dmc, dmr, mask, v):
            ve = v[dmc]
            ye = jnp.einsum("cab,cb->ca", A[:, rs, cs], ve)                 * mask[:, None]
            y = jnp.zeros((n_out,), dtype).at[dmr].add(ye)
            return jax.lax.psum(y, "cells")

        y = shard_map(
            local,
            mesh=self.device_mesh,
            in_specs=(P("cells"), P("cells"), P("cells"), P("cells"),
                      P()),
            out_specs=P(),
        )(A_cells, dm_col, dm_row, self.cell_mask, v)
        for dmf, A_f in A_blocks:
            dmf_col = dmf[:, cs] if col_u else dmf[:, cs] - n_u_flat
            dmf_row = dmf[:, rs] if row_u else dmf[:, rs] - n_u_flat
            vf = v[dmf_col]
            yf = jnp.einsum("fab,fb->fa", A_f[:, rs, cs], vf)
            y = y.at[dmf_row].add(yf)
        return y

    def facet_flux(self, u, name):
        return self.inner.facet_flux(u, name)

    def __getattr__(self, name):
        # delegate everything else (n_u_flat, apply_sub_block,
        # pressure_matrices, scatters, tables, ...) to the serial form
        return getattr(self.inner, name)
