"""Boundary (facet) term kernels for the hemodynamic BC suite.

Each factory returns a per-facet kernel
    kernel(u_e, p_e, aux_e, coords_e, tabs, prm) -> r_u (nbu, dim)
with tabs = dict(phi_u, dphi_u, phi_p, gdphi, normal, dS, h) — the facet
quadrature tables built by StabilizedNSForm.add_facet_term. These are the
JAX equivalents of the reference's `ds` measure terms:

- natural_correction: `p n·v - mu (nabla_grad u)^T n·v` on all exterior
  facets (stabilized_schur.py:79)
- weak_pressure: `scale * pbar (v·n)` — weak/natural pressure BC
  (stabilized_schur_pressure_backflow.py:193 inlet, :208 outlet where the
  resistance pressure p_c enters with scale 0.5)
- viscous_traction_out: `- (2 mu eps(u) n)·v` — the outlet stress
  correction (stabilized_schur_pressure_backflow.py:209)
- nitsche_tangential: symmetric Nitsche enforcement of u_T = 0
  (stabilized_schur_pressure_backflow.py:195-201)
- backflow: Moghadam et al. 2011 Eq. 10 stabilization
  `- beta rho (u_prev·n)_- (u·v)` (stabilized_schur_backflow.py:166-176)
- cbc: convective-like boundary condition, `- 1/2 (u_prev·n)(u·v)`
  (Simon & Notsu 2021; stabilized_schur_vascularbc_cbc.py)
- directional_do_nothing: `- 1/2 (u·n)_- (u·v)` (Braack & Mucha 2014;
  stabilized_schur_vascularbc_ddn.py)

The `vel` selector picks the time-scheme velocity the term acts on:
Crank-Nicolson midpoint by default, `implicit_velocity` for BDF2.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import det_and_inv


def midpoint_velocity(u_e, aux_e):
    return 0.5 * (u_e + aux_e[0])


def implicit_velocity(u_e, aux_e):
    return u_e


def _phys_grad_u(tabs, coords_e):
    """Physical gradients of the velocity basis at the facet quadrature
    points: (nq, nbu, gdim)."""
    J = jnp.einsum("vg,qvd->qgd", coords_e, tabs["gdphi"])
    _, invJ = det_and_inv(J)
    return jnp.einsum("qbd,qdg->qbg", tabs["dphi_u"], invJ)


def natural_correction(vel=midpoint_velocity):
    """`p n·v - mu (nabla_grad u)^T n·v` (UFL transpose convention —
    see forms/navier_stokes.py module docstring)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        n, dS = tabs["normal"], tabs["dS"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = jnp.einsum("bi,qbg->qig", um, gu)
        p_q = tabs["phi_p"] @ p_e
        gtn = jnp.einsum("qjg,qj->qg", grad_um, n)
        term = p_q[:, None] * n - mu * gtn
        return jnp.einsum("q,qb,qi->bi", dS, tabs["phi_u"], term)

    return kernel


def natural_correction_full_stress(vel=midpoint_velocity):
    """`p n·v - 2 mu eps(u) n·v` — the FULL-traction variant: boundary
    rows then see exactly -sigma(u,p) n, so the residual of a field
    satisfying the strong equations vanishes on boundary test functions
    too. Used by the pressure-recovery least squares (solvers_aux/
    pressure.py): the reference's partial `mu nabla_grad(u)^T n`
    convention leaves an O(1) tangential wall traction in the rows that
    no pressure can cancel and biases the fitted gradient ~35% low
    (measured on plane Poiseuille)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        n, dS = tabs["normal"], tabs["dS"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = jnp.einsum("bi,qbg->qig", um, gu)
        p_q = tabs["phi_p"] @ p_e
        eps_n = 0.5 * (
            jnp.einsum("qig,qg->qi", grad_um, n)
            + jnp.einsum("qgi,qg->qi", grad_um, n)
        )
        term = p_q[:, None] * n - 2.0 * mu * eps_n
        return jnp.einsum("q,qb,qi->bi", dS, tabs["phi_u"], term)

    return kernel


def weak_pressure(pressure_key: str, scale: float = 1.0):
    """`+ scale * prm[pressure_key] * (v·n)` — weak pressure traction."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        pbar = prm[pressure_key]
        n, dS = tabs["normal"], tabs["dS"]
        return jnp.einsum(
            "q,qb,qi->bi", dS * scale * pbar, tabs["phi_u"], n
        )

    return kernel


def viscous_traction(vel=midpoint_velocity, sign: float = -1.0):
    """`sign * (2 mu eps(u) n)·v` (outlet stress correction)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        n, dS = tabs["normal"], tabs["dS"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = jnp.einsum("bi,qbg->qig", um, gu)
        eps_u = 0.5 * (grad_um + jnp.swapaxes(grad_um, 1, 2))
        tn = 2.0 * mu * jnp.einsum("qig,qg->qi", eps_u, n)
        return sign * jnp.einsum("q,qb,qi->bi", dS, tabs["phi_u"], tn)

    return kernel


def nitsche_tangential(beta_key: str = "beta_nitsche",
                       vel=midpoint_velocity):
    """Symmetric Nitsche enforcement of zero tangential velocity:
    `-(2 mu eps(u) n)·v_T - (2 mu eps(v) n)·u_T + (beta mu / h) u_T·v_T`
    (stabilized_schur_pressure_backflow.py:195-201)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        beta = prm[beta_key]
        n, dS, h = tabs["normal"], tabs["dS"], tabs["h"]
        phi_u = tabs["phi_u"]
        gu = _phys_grad_u(tabs, coords_e)
        um = vel(u_e, aux_e)
        grad_um = jnp.einsum("bi,qbg->qig", um, gu)
        eps_u = 0.5 * (grad_um + jnp.swapaxes(grad_um, 1, 2))
        u_q = jnp.einsum("qb,bi->qi", phi_u, um)
        uT = u_q - jnp.einsum("qi,qi->q", u_q, n)[:, None] * n

        # consistency: -(2 mu eps(u) n) · v_T, with v = phi_b e_i and
        # v_T,i-component = phi_b (delta_ij - n_i n_j) e_j-th...
        sn = 2.0 * mu * jnp.einsum("qig,qg->qi", eps_u, n)  # (q, i)
        sn_T = sn - jnp.einsum("qi,qi->q", sn, n)[:, None] * n
        ru = -jnp.einsum("q,qb,qi->bi", dS, phi_u, sn_T)

        # symmetry: -(2 mu eps(v) n) · u_T for v = phi_b e_i:
        # eps(v)_{kj} = 1/2 (gphi[b,j] d_ki + gphi[b,k] d_ji)
        # (2 mu eps(v) n)_k = mu (gphi[b,j] n_j d_ki + gphi[b,k] n_i)...
        # contracted with u_T: mu (gphi_b·n) u_T,i + mu (gphi_b·u_T) n_i
        gphin = jnp.einsum("qbg,qg->qb", gu, n)
        gphiuT = jnp.einsum("qbg,qg->qb", gu, uT)
        ru += -mu * jnp.einsum("q,qb,qi->bi", dS, gphin, uT)
        ru += -mu * jnp.einsum("q,qb,qi->bi", dS, gphiuT, n)

        # penalty: (beta mu / h) u_T · v_T; u_T·v_T = phi_b u_T,i since
        # u_T·n = 0
        ru += beta * mu * jnp.einsum(
            "q,qb,qi->bi", dS / h, phi_u, uT
        )
        return ru

    return kernel


def backflow(beta_key: str = "beta_backflow", vel=midpoint_velocity):
    """`- beta rho (u_prev·n)_- (u·v)`; (u·n)_- = (u·n - |u·n|)/2, the
    coefficient is evaluated semi-implicitly at u_prev
    (stabilized_schur_backflow.py:166-176)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        rho = prm["rho"]
        beta = prm[beta_key]
        n, dS = tabs["normal"], tabs["dS"]
        phi_u = tabs["phi_u"]
        up_q = jnp.einsum("qb,bi->qi", phi_u, aux_e[0])
        un_prev = jnp.einsum("qi,qi->q", up_q, n)
        un_minus = 0.5 * (un_prev - jnp.abs(un_prev))
        um = vel(u_e, aux_e)
        u_q = jnp.einsum("qb,bi->qi", phi_u, um)
        return -beta * rho * jnp.einsum(
            "q,qb,qi->bi", dS * un_minus, phi_u, u_q
        )

    return kernel


def cbc(vel=midpoint_velocity):
    """Convective boundary condition: replace sigma·n by
    `1/2 (u_prev·n) u` => residual term `- 1/2 (u_prev·n)(u·v)`
    (stabilized_schur_vascularbc_cbc.py)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        n, dS = tabs["normal"], tabs["dS"]
        phi_u = tabs["phi_u"]
        up_q = jnp.einsum("qb,bi->qi", phi_u, aux_e[0])
        un_prev = jnp.einsum("qi,qi->q", up_q, n)
        um = vel(u_e, aux_e)
        u_q = jnp.einsum("qb,bi->qi", phi_u, um)
        return -0.5 * jnp.einsum("q,qb,qi->bi", dS * un_prev, phi_u, u_q)

    return kernel


def directional_do_nothing(vel=midpoint_velocity):
    """Directional do-nothing outlet: `sigma·n = 1/2 (u·n)_- u`, active
    only under backflow (Braack & Mucha 2014;
    stabilized_schur_vascularbc_ddn.py:187-188, no rho factor).
    Residual: - 1/2 min(u_prev·n, 0) (u·v)."""

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        n, dS = tabs["normal"], tabs["dS"]
        phi_u = tabs["phi_u"]
        up_q = jnp.einsum("qb,bi->qi", phi_u, aux_e[0])
        un_prev = jnp.einsum("qi,qi->q", up_q, n)
        un_minus = jnp.minimum(un_prev, 0.0)
        um = vel(u_e, aux_e)
        u_q = jnp.einsum("qb,bi->qi", phi_u, um)
        return -0.5 * jnp.einsum(
            "q,qb,qi->bi", dS * un_minus, phi_u, u_q
        )

    return kernel


def nitsche_tangential_curl(beta_key: str = "beta_nitsche",
                            vel=midpoint_velocity):
    """Curl-form symmetric Nitsche enforcement of u_T = 0
    (stabilized_schur_pressurebc.py:187-205):
    `- mu (curl u x n)·v_T - mu (curl v x n)·u_T + (beta mu/h) u_T·v_T`.
    2D: curl x n = (-omega n_y, omega n_x) with omega = du_y/dx - du_x/dy.
    """

    def kernel(u_e, p_e, aux_e, coords_e, tabs, prm):
        mu = prm["mu"]
        beta = prm[beta_key]
        n, dS, h = tabs["normal"], tabs["dS"], tabs["h"]
        phi_u = tabs["phi_u"]
        gu = _phys_grad_u(tabs, coords_e)  # (q, b, g)
        um = vel(u_e, aux_e)
        grad_um = jnp.einsum("bi,qbg->qig", um, gu)
        u_q = jnp.einsum("qb,bi->qi", phi_u, um)
        uT = u_q - jnp.einsum("qi,qi->q", u_q, n)[:, None] * n
        dim = n.shape[-1]

        if dim == 2:
            omega = grad_um[:, 1, 0] - grad_um[:, 0, 1]  # (q,)
            ccn_u = jnp.stack(
                [-omega * n[:, 1], omega * n[:, 0]], axis=-1
            )  # (q, 2)
            # curl(phi_b e_i) x n: for i=0 rot = -dphi/dy, i=1 rot = +dphi/dx
            rot_v = jnp.stack([-gu[:, :, 1], gu[:, :, 0]], axis=-1)  # (q,b,i)
            # (omega_v x n) for test (b, i): omega_v = rot_v[q, b, i]
            # -> vector (-omega_v n_y, omega_v n_x)
            ccn_v = jnp.stack(
                [
                    -jnp.einsum("qbi,q->qbi", rot_v, n[:, 1]),
                    jnp.einsum("qbi,q->qbi", rot_v, n[:, 0]),
                ],
                axis=-1,
            )  # (q, b, i, k)
        else:
            curl_um = jnp.stack(
                [
                    grad_um[:, 2, 1] - grad_um[:, 1, 2],
                    grad_um[:, 0, 2] - grad_um[:, 2, 0],
                    grad_um[:, 1, 0] - grad_um[:, 0, 1],
                ],
                axis=-1,
            )
            ccn_u = jnp.cross(curl_um, n)
            eye3 = jnp.eye(3, dtype=gu.dtype)
            curl_v = jnp.cross(gu[:, :, None, :], eye3[None, None, :, :])
            ccn_v = jnp.cross(curl_v, n[:, None, None, :])  # (q, b, i, k)

        # consistency: -mu (curl u x n)·v_T with v = phi_b e_i:
        # v_T,k = phi_b (delta_ki - n_k n_i); dot gives
        # phi_b (ccn_u_i - (ccn_u·n) n_i)
        ccn_uT = ccn_u - jnp.einsum("qk,qk->q", ccn_u, n)[:, None] * n
        ru = -mu * jnp.einsum("q,qb,qi->bi", dS, phi_u, ccn_uT)

        # symmetry: -mu (curl v x n)·u_T
        ru += -mu * jnp.einsum("q,qbik,qk->bi", dS, ccn_v, uT)

        # penalty
        ru += beta * mu * jnp.einsum("q,qb,qi->bi", dS / h, phi_u, uT)
        return ru

    return kernel
