"""Which gather shapes are fast on the current backend?

Hypothesis from spmv_layouts.py: gather cost = a fixed cost per GATHER
OP + fast streaming, so the SpMV must issue ONE big flat gather, not
K*bs small ones; and the 2D row-gather (x[(n,K)] rows of (bs,)) used by
the round-1 ELL matvec may be on a slow path entirely. The supernode
layout (la/superell.py) rests on the answer.

Usage: python scripts/gather_shapes.py [n_nodes]
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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 26116
    K, bs = 10, 3
    rng = np.random.default_rng(0)
    nflat = n * bs
    x_flat = jnp.asarray(rng.standard_normal(nflat + 1), jnp.float32)
    x_rows = jnp.asarray(rng.standard_normal((n + 1, bs)), jnp.float32)
    cols2d = rng.integers(0, n, (n, K)).astype(np.int32)
    cols2d_j = jnp.asarray(cols2d)

    # 1. one flat gather of n*K*bs elements (the proposed layout)
    idx_all = (
        np.arange(bs, dtype=np.int64)[:, None, None] * 0  # placeholder
    )
    idx_flat = (
        (cols2d[None] * bs + np.arange(bs, dtype=np.int64)[:, None, None])
        .reshape(-1).astype(np.int32)
    )  # (bs*n*K,) indices into x_flat
    idx_flat_j = jnp.asarray(idx_flat)
    t = bench(jax.jit(lambda x: x[idx_flat_j]), x_flat)
    print(f"flat 1D gather  {len(idx_flat):>8} elems: {t*1e3:7.3f} ms "
          f"({len(idx_flat)/t/1e9:5.2f} Gelem/s)")

    # 2. same elements, 2D index array (bs*n, K)
    idx_2d = jnp.asarray(idx_flat.reshape(bs * n, K))
    t = bench(jax.jit(lambda x: x[idx_2d]), x_flat)
    print(f"2D-idx gather   {len(idx_flat):>8} elems: {t*1e3:7.3f} ms")

    # 3. row gather (n,K) rows of (bs,) — the round-1 aos pattern
    t = bench(jax.jit(lambda x: x[cols2d_j]), x_rows)
    print(f"row gather      {n*K*bs:>8} elems: {t*1e3:7.3f} ms")

    # 4. K separate flat gathers of n
    colsk = [jnp.asarray(cols2d[:, k]) for k in range(K)]
    t = bench(jax.jit(lambda x: [x[c] for c in colsk]), x_flat[:n + 1])
    print(f"{K} small gathers {n*K:>8} elems: {t*1e3:7.3f} ms")

    # 5. the fused einsum FMA at SpMV shape
    vals = jnp.asarray(
        rng.standard_normal((K, bs, bs, n)), jnp.float32
    )
    xg = jnp.asarray(rng.standard_normal((bs, K, n)), jnp.float32)
    t = bench(jax.jit(
        lambda v, g: jnp.einsum("kabn,bkn->an", v, g)), vals, xg)
    print(f"einsum kabn,bkn->an (n={n}):    {t*1e3:7.3f} ms "
          f"({vals.size*4/t/1e9:6.1f} GB/s vals)")

    # 6. proposed full matvec: 1 flat gather + reshape + einsum
    def mv(x):
        xg = x[idx_flat_j].reshape(bs, n, K).transpose(0, 2, 1)
        return jnp.einsum("kabn,bkn->an", vals, xg)
    t = bench(jax.jit(mv), x_flat)
    print(f"full matvec (gather+einsum):    {t*1e3:7.3f} ms "
          f"({vals.size*4/t/1e9:6.1f} GB/s vals)")

    # 7. variant: xg kept (bs, n, K), einsum adapted
    def mv2(x):
        xg = x[idx_flat_j].reshape(bs, n, K)
        return jnp.einsum("kabn,bnk->an", vals, xg)
    t = bench(jax.jit(mv2), x_flat)
    print(f"full matvec (no transpose):     {t*1e3:7.3f} ms")

    # 8. vals in (n-minor) layout but K*bs*bs fused planes: (K*bs*bs, n)
    vals2 = vals.reshape(K * bs * bs, n)

    def mv3(x):
        xg = x[idx_flat_j].reshape(bs, 1, K, n)          # b, 1, k, n
        xg = jnp.broadcast_to(xg, (bs, bs, K, n))        # b, a, k, n
        xg = xg.transpose(2, 1, 0, 3).reshape(K * bs * bs, n)
        return jnp.sum(
            (vals2 * xg).reshape(K, bs, bs, n), axis=(0, 2)
        )
    t = bench(jax.jit(mv3), x_flat)
    print(f"full matvec (flat planes):      {t*1e3:7.3f} ms")


if __name__ == "__main__":
    main()
