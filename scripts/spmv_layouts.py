"""SpMV layout microbenchmark: where does the node-BSR matvec time go?

Question: is the bottleneck of the assembled node-BSR ELL matvec the
gather, or how XLA lays out the blocked einsum "nkab,nkb->na" on
(n, K, bs, bs) arrays (bs = dim+1 = 3 in 2D), whose minor dimensions are
tiny?

This bench compares:
  aos   : the round-1 layout (n, K, bs, bs) + einsum           [baseline]
  soa   : structure-of-arrays (K, bs, bs, n) planes, x (bs, n) —
          every elementwise op runs on (n,)-major arrays (full lanes),
          the K/bs loops are unrolled python loops over planes
  gather: the raw neighbour gather cost alone, both layouts

Usage:  python scripts/spmv_layouts.py [res_scale]    (default 0.25 ~ 160k DOF)
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def bench(fn, *args, reps=50):
    y = fn(*args)
    jax.block_until_ready(y)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(*args)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / reps


def main():
    res_scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark
    from cfdtpu.la.nodebsr import NodeBSR

    sc = DFG1Benchmark(
        "stabilized_schur", dt=0.05, T=1e9, res_scale=res_scale,
        dtype="auto",
    )
    s = sc.solver
    form = s.form
    prm = s.params()
    A_cells, A_blocks = jax.jit(
        lambda u, p: form.element_jacobians(u, p, (u,), prm)
    )(s.u_prev, s.p_prev)
    bsr = NodeBSR(form)
    vals = jax.jit(bsr.assemble)(A_cells, A_blocks)
    n, K, bs = bsr.n_nodes, bsr.K, bsr.bs
    itemsize = np.dtype(form.dtype).itemsize
    print(f"n_nodes={n} K={K} bs={bs} blocks={bsr.n_blocks} "
          f"dofs={form.n_flat}")
    ell_bytes = n * K * bs * bs * itemsize
    v = jnp.ones((form.n_flat,), form.dtype)

    # --- aos (round-1 path) ---------------------------------------------
    mv_aos = jax.jit(lambda v: bsr.apply_element_matrices(vals, (), v))
    t = bench(mv_aos, v)
    print(f"aos   matvec: {t*1e3:8.3f} ms  {ell_bytes/t/1e9:7.2f} GB/s(vals)")
    y_ref = mv_aos(v)

    # gather alone, aos layout: x_ext[(n,K)] rows of (bs,)
    xn = bsr._to_nodes(v)
    g_aos = jax.jit(lambda xn: bsr._ell_gather(xn))
    t = bench(g_aos, xn)
    print(f"aos   gather: {t*1e3:8.3f} ms  ({n*K*bs*itemsize/t/1e9:.2f} GB/s out)")

    # --- soa layout -------------------------------------------------------
    pad = (-n) % 128
    npad = n + pad
    vals_soa = jnp.transpose(vals["ell"], (1, 2, 3, 0))  # (K, bs, bs, n)
    vals_soa = jnp.pad(vals_soa, ((0, 0),) * 3 + ((0, pad),))
    cols_soa = jnp.pad(
        jnp.transpose(bsr._ell_cols, (1, 0)), ((0, 0), (0, pad)),
        constant_values=n,
    )  # (K, npad) entries == n mean "padding"
    x_soa = jnp.zeros((bs, npad + 1), form.dtype)  # +1: padding slot

    def to_soa(v):
        xn = bsr._to_nodes(v)  # (n, bs)
        return x_soa.at[:, :n].set(xn.T)

    def mv_soa(x):  # x (bs, npad+1)
        y = [jnp.zeros((npad,), x.dtype) for _ in range(bs)]
        for k in range(K):
            xg = x[:, cols_soa[k]]  # (bs, npad) gather along lanes
            for a in range(bs):
                acc = y[a]
                for b in range(bs):
                    acc = acc + vals_soa[k, a, b] * xg[b]
                y[a] = acc
        return jnp.stack(y)

    mv_soa_j = jax.jit(mv_soa)
    x1 = to_soa(v)
    y_soa = mv_soa_j(x1)
    err = float(jnp.max(jnp.abs(
        bsr._to_nodes(y_ref).T - y_soa[:, :n]
    )))
    t = bench(mv_soa_j, x1)
    print(f"soa   matvec: {t*1e3:8.3f} ms  {ell_bytes/t/1e9:7.2f} GB/s(vals)"
          f"  maxerr={err:.2e}")

    # gather alone, soa layout
    def g_soa(x):
        return jnp.stack([x[:, cols_soa[k]] for k in range(K)])

    t = bench(jax.jit(g_soa), x1)
    print(f"soa   gather: {t*1e3:8.3f} ms")

    # --- soa with a single flat gather ------------------------------------
    def mv_soa2(x):  # one (K*npad,) gather per component
        cols_flat = cols_soa.reshape(-1)
        y = [jnp.zeros((npad,), x.dtype) for _ in range(bs)]
        xg_all = x[:, cols_flat].reshape(bs, K, npad)
        for k in range(K):
            for a in range(bs):
                acc = y[a]
                for b in range(bs):
                    acc = acc + vals_soa[k, a, b] * xg_all[b, k]
                y[a] = acc
        return jnp.stack(y)

    mv2 = jax.jit(mv_soa2)
    y2 = mv2(x1)
    err2 = float(jnp.max(jnp.abs(y2[:, :n] - y_soa[:, :n])))
    t = bench(mv2, x1)
    print(f"soa2  matvec: {t*1e3:8.3f} ms  {ell_bytes/t/1e9:7.2f} GB/s(vals)"
          f"  maxerr={err2:.2e}")


if __name__ == "__main__":
    main()


def soa3(bsr, vals, form):
    """Fully-flat per-component SoA: 1D gathers (fast XLA path) + (n,)
    elementwise FMAs."""
    import jax, jax.numpy as jnp, numpy as np, time
    n, K, bs = bsr.n_nodes, bsr.K, bsr.bs
    pad = (-n) % 512
    npad = n + pad
    # vals planes: [k][a][b] -> (npad,)
    vplanes = [[[jnp.pad(vals["ell"][:, k, a, b], (0, pad))
                 for b in range(bs)] for a in range(bs)] for k in range(K)]
    cols = np.asarray(bsr._ell_cols)  # (n, K) sentinel n
    colsk = [jnp.asarray(np.pad(cols[:, k], (0, pad),
                                constant_values=n).astype(np.int32))
             for k in range(K)]

    def mv(xb):  # xb: list of bs flat (npad+1,) arrays (sentinel slot 0)
        y = [jnp.zeros((npad,), xb[0].dtype) for _ in range(bs)]
        for k in range(K):
            xg = [xb[b][colsk[k]] for b in range(bs)]
            for a in range(bs):
                acc = y[a]
                for b in range(bs):
                    acc = acc + vplanes[k][a][b] * xg[b]
                y[a] = acc
        return y

    return jax.jit(mv), npad


def main_soa3(res_scale=0.25):
    import jax, jax.numpy as jnp
    from cfdtpu.scenarios.dfg_1 import DFG1Benchmark
    from cfdtpu.la.nodebsr import NodeBSR

    sc = DFG1Benchmark("stabilized_schur", dt=0.05, T=1e9,
                       res_scale=res_scale, dtype="auto")
    s = sc.solver
    form = s.form
    prm = s.params()
    A_cells, A_blocks = jax.jit(
        lambda u, p: form.element_jacobians(u, p, (u,), prm))(
        s.u_prev, s.p_prev)
    bsr = NodeBSR(form)
    vals = jax.jit(bsr.assemble)(A_cells, A_blocks)
    n, K, bs = bsr.n_nodes, bsr.K, bsr.bs
    itemsize = np.dtype(form.dtype).itemsize
    ell_bytes = n * K * bs * bs * itemsize
    mv, npad = soa3(bsr, vals, form)
    v = jnp.ones((form.n_flat,), form.dtype)
    xn = bsr._to_nodes(v)
    xb = [jnp.concatenate([xn[:, b], jnp.zeros(npad - n + 1, form.dtype)])
          for b in range(bs)]
    y = mv(xb)
    # correctness vs aos
    y_ref = bsr._to_nodes(
        bsr.apply_element_matrices(vals, (), v))
    err = max(float(jnp.max(jnp.abs(y[b][:n] - y_ref[:, b])))
              for b in range(bs))
    t = bench(lambda xb: mv(xb), xb, reps=50)
    print(f"soa3  matvec: {t*1e3:8.3f} ms  {ell_bytes/t/1e9:7.2f} GB/s(vals)"
          f"  maxerr={err:.2e}  (n={n} K={K})")


if __name__ == "__main__" and "soa3" in sys.argv:
    pass
