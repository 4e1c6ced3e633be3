"""Exact linear-assignment solve (Jonker-Volgenant shortest augmenting path)
in fixed-shape JAX.

Replaces the reference's external Munkres/Hungarian library call
(``include/dsp_dynamic.h:1474-1475``, ``libmunkres.a`` per
``CMakeLists.txt:31-34``).  The solver is the classic O(n^3)
potentials-plus-Dijkstra formulation: for each row, grow a shortest
augmenting path over columns (the inner relaxation is a vectorized column
sweep), update dual potentials by the bottleneck slack, and flip the path.
All loops are ``lax.fori_loop`` / ``lax.while_loop`` with static bounds --
cluster counts are small (<= ``MapConfig.max_clusters``), so this is microsec
work once jitted, and unlike an auction it is exact and deterministic, which
keeps cross-frame track association reproducible.

Rectangular instances are squared up with a finite dummy cost above the real
range: any matching on real pairs dominates a dummy pair, so the square
optimum restricted to real columns is exactly the rectangular Munkres result
(per-pair swap argument); dummy assignments are reported as "no match".

Small-instance fast path: every sequential JV path iteration is one device
loop trip, so when all valid rows AND columns lie in the leading 8x8 block
(realized cluster counts are 2-5) the solve is done by exhaustive
enumeration instead: one constant one-hot ``[8!, 64]`` matrix turns "cost of
every permutation" into a single matmul ``P8 @ a8.ravel()`` followed by an
argmin -- exact by definition, no sequential loop.  The JV
loop remains the fallback for larger instances.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.float32(1.0e12)

#: brute-force bucket width (8! = 40320 permutations; 9! would be 2.9 MB of
#: index table and a 23 MB one-hot -- past the sweet spot).
_BRUTE_N = 8


@functools.lru_cache(maxsize=None)
def _perm_tables():
    """(perms [8!, 8] i32, onehot [8!, 64] f32) -- built once per process."""
    import itertools

    perms = np.array(
        list(itertools.permutations(range(_BRUTE_N))), dtype=np.int32
    )
    n = perms.shape[0]
    onehot = np.zeros((n, _BRUTE_N * _BRUTE_N), np.float32)
    rows = np.repeat(np.arange(n), _BRUTE_N)
    cols = (np.arange(_BRUTE_N)[None, :] * _BRUTE_N + perms).ravel()
    onehot[rows, cols] = 1.0
    return perms, onehot


def _brute_small(a: jnp.ndarray) -> jnp.ndarray:
    """Exact assignment of the leading ``[_BRUTE_N, _BRUTE_N]`` block of the
    squared-up cost ``a`` by permutation enumeration.  Returns
    ``col_of_row[_BRUTE_N]`` (0-based, always assigned -- dummy pairs are
    stripped by the caller exactly as for the JV path)."""
    perms, onehot = _perm_tables()
    flat = a[:_BRUTE_N, :_BRUTE_N].reshape(-1)  # [64]
    # full f32: the argmin compares totals that can differ in the last
    # digits, which a TF32 product would round away
    totals = jnp.dot(jnp.asarray(onehot), flat,
                     precision=jax.lax.Precision.HIGHEST)  # [8!]
    best = jnp.argmin(totals)
    return jnp.asarray(perms)[best]


@jax.jit
def solve_assignment(
    cost: jnp.ndarray,  # [R, C] finite costs (smaller = better)
    row_valid: jnp.ndarray,  # [R] bool
    col_valid: jnp.ndarray,  # [C] bool
) -> jnp.ndarray:
    """Min-cost one-to-one assignment.  Returns ``col_of_row[R]`` (-1 = none).

    Rows in excess of the valid-column count stay unassigned, mirroring a
    rectangular Munkres solve.
    """
    R, C = cost.shape
    N = max(R, C, _BRUTE_N)
    pair_ok = row_valid[:, None] & col_valid[None, :]
    spread = jnp.maximum(jnp.max(jnp.where(pair_ok, cost, 0.0)), 1.0)
    dummy = spread * 2.0 + 1.0
    a = jnp.full((N, N), 0.0, jnp.float32)
    a = a.at[:R, :C].set(jnp.where(pair_ok, cost.astype(jnp.float32), dummy))
    a = jnp.where(
        (jnp.arange(N)[:, None] >= R) | (jnp.arange(N)[None, :] >= C), dummy, a
    )

    # e-maxx formulation with a virtual column 0; arrays are 1-indexed on the
    # column axis (size N+1), p[j] = row matched to column j (0 = none yet).
    #
    # The inner path loop is sequential (one device loop trip per
    # iteration, whatever N), so the classic per-iteration dual updates are
    # reorganized into a cumulative-delta form with strictly fewer HLO ops
    # per iteration:
    #
    # * v[j] only ever changes for USED columns, and the relaxation reads
    #   v[j] only for UNUSED ones -- so v never needs updating inside the
    #   loop.
    # * u[p[j0]] for the active used column j0 grows by delta every
    #   iteration since j0 became used, i.e. u_now[p[j0]] = u0[p[j0]] +
    #   (D_now - D_use[j0]) where D is the running delta sum.  Substituting
    #   into the relaxation and storing minv in "absolute" terms
    #   M[j] = minv_now[j] + D_now (invariant between updates, since every
    #   unused minv drops by delta exactly as D grows by delta) cancels
    #   D_now entirely:  cand_M[j] = a[i0-1,j] - u0[i0] - v0[j] + D_use[j0],
    #   and the bottleneck step collapses to D_next = min over unused of M.
    #
    # The dual potentials are reconstructed once per row after the loop:
    # amt[j] = D_final - D_use[j] for used j, v -= amt, u[p] += amt -- the
    # same values the per-iteration updates would have accumulated.
    def assign_row(carry, i):
        u, v, p = carry  # u:[N+1] row potentials, v:[N+1], p:[N+1] owners
        i = i.astype(jnp.int32)

        p = p.at[0].set(i)
        iota1 = jnp.arange(N + 1, dtype=jnp.int32)

        def path_cond(st):
            _, _, _, _, j0, _, done = st
            return ~done

        def path_body(st):
            m_abs, way, used, d_use, j0, d_now, _ = st
            used = used | (iota1 == j0)
            d_use = jnp.where(iota1 == j0, d_now, d_use)
            i0 = p[j0]
            # relax all unused columns through row i0 (absolute-M space)
            cand = a[i0 - 1, :] - u[i0] - v[1:] + d_now
            better = (~used[1:]) & (cand < m_abs)
            m_abs = jnp.where(better, cand, m_abs)
            way = jnp.where(better, j0, way)
            # bottleneck column: D jumps straight to the unused minimum
            masked = jnp.where(used[1:], INF, m_abs)
            j1 = jnp.argmin(masked).astype(jnp.int32) + 1
            d_next = masked[j1 - 1]
            done = p[j1] == 0
            return m_abs, way, used, d_use, j1, d_next, done

        m_abs, way1, used, d_use, j0, d_final, _ = jax.lax.while_loop(
            path_cond, path_body,
            (
                jnp.full((N,), INF),  # M over real columns 1..N
                jnp.zeros((N,), jnp.int32),
                jnp.zeros((N + 1,), bool),
                jnp.zeros((N + 1,), jnp.float32),
                jnp.int32(0),
                jnp.float32(0.0),
                jnp.bool_(False),
            ),
        )
        # dual reconstruction (once per row, not per iteration)
        amt = jnp.where(used, d_final - d_use, 0.0)
        u = u.at[p].add(amt)
        v = v - amt
        way = jnp.concatenate([jnp.zeros((1,), jnp.int32), way1])

        # unwind the augmenting path
        def unwind_cond(st):
            _, j0 = st
            return j0 != 0

        def unwind_body(st):
            p, j0 = st
            j1 = way[j0]
            p = p.at[j0].set(p[j1])
            return p, j1

        p, _ = jax.lax.while_loop(unwind_cond, unwind_body, (p, j0))
        return (u, v, p), None

    u0 = jnp.zeros((N + 1,), jnp.float32)
    v0 = jnp.zeros((N + 1,), jnp.float32)
    p0 = jnp.zeros((N + 1,), jnp.int32)

    # Only augment real (valid) rows: every sequential path iteration is a
    # loop trip and realized cluster counts are 2-5 of the max_clusters=16
    # capacity.  Dummy rows can only claim dummy-cost pairs,
    # which are stripped below, so skipping them leaves the real matching
    # optimal (square-up dominance argument in the module docstring).
    n_rows = jnp.max(
        jnp.where(row_valid, jnp.arange(1, R + 1, dtype=jnp.int32), 0)
    )

    def rows_cond(st):
        i, _ = st
        return i <= n_rows

    def rows_body(st):
        i, carry = st
        carry, _ = assign_row(carry, i)
        return i + 1, carry

    def _jv_res():
        _, (_, _, p) = jax.lax.while_loop(
            rows_cond, rows_body, (jnp.int32(1), (u0, v0, p0))
        )
        # p[j] = row (1-based) matched to col j (1-based) -> col_of_row
        col_of_row = (
            jnp.full((N + 1,), -1, jnp.int32)
            .at[p[1:]]
            .set(jnp.arange(1, N + 1, dtype=jnp.int32))
        )
        r = col_of_row[1 : R + 1] - 1  # back to 0-based columns
        return jnp.where((r >= 0) & (r < C), r, -1)

    def _brute_res():
        cols8 = _brute_small(a)
        r = jnp.full((N,), -1, jnp.int32).at[:_BRUTE_N].set(cols8)[:R]
        return jnp.where(r < C, r, -1)

    # All valid rows AND columns inside the leading 8x8 block -> the dense
    # enumeration is exact for the whole instance (everything outside the
    # block is dummy-cost padding, stripped below like any dummy pair).
    small = ~(
        jnp.any(row_valid[_BRUTE_N:]) | jnp.any(col_valid[_BRUTE_N:])
    )
    res = jax.lax.cond(small, _brute_res, _jv_res)
    # strip dummy-cost pairs (invalid pairs / padding)
    is_real = (
        row_valid
        & (res >= 0)
        & jnp.take_along_axis(
            pair_ok, jnp.maximum(res, 0)[:, None], axis=1
        )[:, 0]
    )
    return jnp.where(is_real, res, -1)


# Backwards-compatible alias (earlier revisions shipped an auction solver).
def auction_assignment(cost, row_valid, col_valid, **_ignored):
    return solve_assignment(cost, row_valid, col_valid)
