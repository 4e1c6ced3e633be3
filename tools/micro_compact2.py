"""Microbench the compact-core primitive costs at population widths on the
default JAX device: multi-column scatter-add vs segment-table, sorts with
payload operands, stacked gathers, scans, compact_mask."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def bench(fn, *args, n=30):
    fn(*args)[0].block_until_ready()
    r = fn(*args)
    float(jax.tree.leaves(r)[0].ravel()[0])
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    float(jax.tree.leaves(r)[0].ravel()[0])
    return (time.perf_counter() - t0) / n * 1000


def main():
    V = 175104
    rng = np.random.default_rng(0)
    for P in (32768, 49152, 65536, 131072):
        cell = jnp.asarray(rng.integers(0, V, P), jnp.int32)
        cols8 = jnp.asarray(rng.normal(size=(P, 8)), jnp.float32)
        w = cols8[:, 0]
        iota = jnp.arange(P, dtype=jnp.int32)
        perm = jnp.asarray(rng.permutation(P), jnp.int32)

        @jax.jit
        def scat_add_1(cell, w):
            return (jnp.zeros((V + 1,), jnp.float32).at[cell].add(w),)

        @jax.jit
        def scat_add_8(cell, cols8):
            return (jnp.zeros((V + 1, 8), jnp.float32).at[cell].add(cols8),)

        @jax.jit
        def scat_set_8_unique(iota, cols8):
            return (jnp.zeros((P + 1, 8), jnp.float32).at[iota].set(
                cols8, unique_indices=True),)

        @jax.jit
        def gather_rand(perm, w):
            return (w[perm],)

        @jax.jit
        def gather_stacked(perm, cols8):
            # [P, 8] row gather from an [P, 8] table (contiguous rows)
            return (cols8[perm],)

        @jax.jit
        def sort2(cell, iota):
            return jax.lax.sort((cell, iota), num_keys=1, is_stable=True)

        @jax.jit
        def sort5(cell, iota, cols8):
            return jax.lax.sort(
                (cell, iota, cols8[:, 0], cols8[:, 1], cols8[:, 2]),
                num_keys=1, is_stable=True)

        @jax.jit
        def sort9(cell, iota, cols8):
            return jax.lax.sort(
                (cell, iota) + tuple(cols8[:, i] for i in range(7)),
                num_keys=1, is_stable=True)

        @jax.jit
        def scans(w):
            c = jnp.cumsum(w)
            b = jax.lax.cummax(c)
            return (c + b,)

        from dspmap_tpu.ops.common import compact_mask

        @jax.jit
        def cmask(w):
            i, v, n, o = compact_mask(w > 0, 16384)
            return (i,)

        @jax.jit
        def seg_table_4(cell, cols8):
            # partial-run sums -> bucket-compacted end scatter (segment-table
            # candidate): 4 cols, bucket 16384
            key = cell
            valid = jnp.ones((P,), bool)
            is_end = jnp.concatenate([key[1:] != key[:-1],
                                      jnp.ones((1,), bool)])
            is_start = jnp.concatenate([jnp.ones((1,), bool),
                                        key[1:] != key[:-1]])
            start_row = jax.lax.cummax(jnp.where(is_start, iota, 0))
            cums = [jnp.cumsum(cols8[:, i]) for i in range(4)]
            e_i, e_ok, _, e_over = compact_mask(is_end, 16384)
            sr = start_row[e_i]
            lo_i = jnp.maximum(sr - 1, 0)
            outs = []
            for c in cums:
                hi = c[e_i]
                lo = jnp.where(sr > 0, c[lo_i], 0.0)
                outs.append(hi - lo)
            upd = jnp.stack(outs, -1)
            tbl = jnp.zeros((V + 1, 4), jnp.float32).at[
                jnp.where(e_ok, key[e_i], V)].add(upd)
            return (tbl,)

        rows = [
            ("scat_add_1col", bench(scat_add_1, cell, w)),
            ("scat_add_8col", bench(scat_add_8, cell, cols8)),
            ("scat_set8_uni", bench(scat_set_8_unique, iota, cols8)),
            ("gather_rand_1", bench(gather_rand, perm, w)),
            ("gather_rows_8", bench(gather_stacked, perm, cols8)),
            ("sort2", bench(sort2, cell, iota)),
            ("sort5", bench(sort5, cell, iota, cols8)),
            ("sort9", bench(sort9, cell, iota, cols8)),
            ("cumsum+cummax", bench(scans, w)),
            ("compact_mask16k", bench(cmask, w)),
            ("seg_table_4col", bench(seg_table_4, cell, cols8)),
        ]
        print(f"P={P}")
        for name, ms in rows:
            print(f"  {name:16s} {ms:7.3f} ms")


if __name__ == "__main__":
    main()
