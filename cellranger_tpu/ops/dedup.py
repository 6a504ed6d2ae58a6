"""UMI correction + duplicate marking as sorted-segment device ops.

Re-expresses the reference's per-barcode hashmap algorithm
(lib/rust/tx_annotation/src/mark_dups.rs) as fixed-shape batched array ops:

  * correct_umis (mark_dups.rs:19-59): each distinct (bc, gene, umi) moves to
    the 1-Hamming neighbor UMI with strictly greater read count, or equal
    count and lexicographically larger UMI (packed-u32 order == lex order).
  * the Cell Ranger 3 two-phase count movement (mark_dups.rs:227-247): ONE
    read of each corrected UMI moves before low-support determination, the
    remainder after.
  * determine_low_support_umigenes (mark_dups.rs:87-108): within each
    (bc, umi), the top gene by read count survives; on a tie for the max all
    genes are marked low-support (putative chimeras).

Instead of per-barcode HashMaps on threads, everything is a lexicographic
sort (lax.sort, multi-key) + segmented reductions + batched binary-search
joins over the sorted tables. All shapes static; invalid rows carry sentinel
keys that sort to the end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .scan import cummax

U32_MAX = jnp.uint32(0xFFFFFFFF)


def _ceil_log2(n: int) -> int:
    b = 1
    while (1 << b) < n:
        b += 1
    return b


def lex3_search(k1, k2, k3, q1, q2, q3):
    """Leftmost index where sorted (k1,k2,k3) >= query tuple; all uint32.

    Returns (idx int32, found bool) — found iff exact tuple present.
    """
    N = k1.shape[0]
    iters = _ceil_log2(max(N, 2)) + 1
    lo = jnp.zeros(q1.shape, jnp.int32)
    hi = jnp.full(q1.shape, N, jnp.int32)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        midc = jnp.clip(mid, 0, N - 1)
        a, b, c = k1[midc], k2[midc], k3[midc]
        lt = (a < q1) | ((a == q1) & ((b < q2) | ((b == q2) & (c < q3))))
        lt = lt & (mid < hi)  # guard degenerate
        lo = jnp.where(lt, mid + 1, lo)
        hi = jnp.where(lt, hi, mid)
    idx = jnp.clip(lo, 0, N - 1)
    found = (lo < N) & (k1[idx] == q1) & (k2[idx] == q2) & (k3[idx] == q3)
    return idx, found


def _seg_ids(new_seg):
    """bool [N] first-of-segment flags -> int32 segment ids."""
    return jnp.cumsum(new_seg.astype(jnp.int32)) - 1


@functools.partial(jax.jit, donate_argnums=(0,))
def exact_merge(rows, n):
    """Merge identical (bc, gene, umi) triples of a device-resident
    molecule buffer, summing read counts — the incremental pre-merge of
    the accumulate-mode dedup (the UMI-correction rules operate on
    distinct triples + counts, so exact merging is always safe).

    rows: uint32 [C, 4] (bc, gene, umi, reads); only rows [0, n) are
    live.  Returns (rows', n') with the merged triples sorted by
    (bc, gene, umi) and compacted to the front; the tail is sentinel.
    """
    C = rows.shape[0]
    live = jnp.arange(C, dtype=jnp.int32) < n
    sent = U32_MAX
    bc = jnp.where(live, rows[:, 0], sent)
    gene = jnp.where(live, rows[:, 1], sent)
    umi = jnp.where(live, rows[:, 2], sent)
    w = jnp.where(live, rows[:, 3], 0)
    bc_s, gene_s, umi_s, w_s = jax.lax.sort((bc, gene, umi, w), num_keys=3)
    valid_s = bc_s != sent
    new_t = jnp.concatenate(
        [jnp.ones(1, bool),
         (bc_s[1:] != bc_s[:-1]) | (gene_s[1:] != gene_s[:-1])
         | (umi_s[1:] != umi_s[:-1])])
    tid = _seg_ids(new_t)
    reads = jax.ops.segment_sum(
        jnp.where(valid_s, w_s, 0).astype(jnp.uint32), tid, num_segments=C)
    is_repr = new_t & valid_s
    dst = jnp.where(is_repr, tid, C)      # C = drop
    out = jnp.full((C, 4), sent, jnp.uint32)
    vals = jnp.stack([bc_s, gene_s, umi_s, reads[tid]], axis=1)
    out = out.at[dst].set(vals, mode="drop")
    n_out = jnp.sum(is_repr.astype(jnp.int32))
    return out, n_out


@functools.partial(jax.jit, static_argnames=("umi_len",))
def dedup_molecules(bc, gene, umi, valid, umi_len: int, reads=None):
    """Full UMI correction + low-support marking + molecule counting.

    Inputs (all [N]): bc uint32 (barcode index or packed seq), gene uint32,
    umi uint32 (2-bit packed), valid bool (conf-mapped rows only), and
    optionally reads (uint32 weight per row — pre-merged distinct triples
    from the device-resident accumulator carry their read counts; None
    means every row is one read).

    Returns dict of [N] arrays describing the deduplicated molecule table:
      mol_bc/mol_gene/mol_umi: corrected molecule keys (sorted by
        (bc, gene, corrected umi); one representative row per molecule),
      mol_reads: reads per molecule,
      mol_valid: representative & not low-support,
      n_molecules: scalar count of valid molecules.
    """
    N = bc.shape[0]
    sent = U32_MAX

    bc = jnp.where(valid, bc, sent)
    gene = jnp.where(valid, gene, sent)
    umi = jnp.where(valid, umi, sent)
    w = (jnp.ones(N, jnp.uint32) if reads is None
         else jnp.asarray(reads, jnp.uint32))

    # ---- phase 0: sort triples, count reads per distinct (bc, gene, umi) ----
    bc_s, gene_s, umi_s, w_s = jax.lax.sort((bc, gene, umi, w), num_keys=3)
    valid_s = bc_s != sent
    new_triple = jnp.concatenate(
        [jnp.ones(1, bool),
         (bc_s[1:] != bc_s[:-1]) | (gene_s[1:] != gene_s[:-1])
         | (umi_s[1:] != umi_s[:-1])])
    tid = _seg_ids(new_triple)
    reads_per_triple = jax.ops.segment_sum(
        jnp.where(valid_s, w_s.astype(jnp.int32), 0), tid, num_segments=N)
    cnt = reads_per_triple[tid]              # [N] count of own triple
    is_repr = new_triple & valid_s

    # ---- phase 1: UMI correction per distinct triple ----
    # WILDCARD sort-join (r5): instead of materializing all 3*umi_len
    # point mutants per row (a (3L+1)*N-row 6-column sort — the 228s
    # dedup wall of the r4 20M-read run), emit umi_len position-masked
    # keys per row.  Two triples are 1-Hamming neighbors iff they share
    # a masked key: within each sorted (bc-gene-segment, pos, masked-umi)
    # run all members are mutual neighbors, so the reference's move rule
    # (mark_dups.rs:42-49 — lex-max (count, umi) neighbor that beats
    # self) is a segmented prefix/suffix lex-max EXCLUDING self.  umi_len
    # * N rows with 5 u32 columns, ~5x less sort traffic, no tag/
    # fill-forward machinery.
    new_bg = jnp.concatenate(
        [jnp.ones(1, bool),
         (bc_s[1:] != bc_s[:-1]) | (gene_s[1:] != gene_s[:-1])])
    sid = _seg_ids(new_bg).astype(jnp.uint32)  # (bc, gene) segment id < N
    posu = jnp.arange(umi_len, dtype=jnp.uint32)
    shifts = (2 * (umi_len - 1 - posu)).astype(jnp.uint32)
    maskv = ~(jnp.uint32(3) << shifts)                       # [L]
    L = umi_len
    # hi key: (sid, pos); lo key: masked umi.  Invalid rows get an
    # all-ones hi key (sid of sentinel runs is harmless: their cnt is 0).
    hi = (sid[None, :] * jnp.uint32(L) + posu[:, None]).reshape(-1)
    hi = jnp.where(jnp.tile(valid_s, L), hi, U32_MAX)
    lo = (umi_s[None, :] & maskv[:, None]).reshape(-1)       # [L*N]
    c_cnt = jnp.tile(cnt.astype(jnp.uint32), L)
    c_umi = jnp.tile(umi_s, L)
    c_row = jnp.tile(jnp.arange(N, dtype=jnp.uint32), L)
    shi, slo, scnt, sumi, srow = jax.lax.sort(
        (hi, lo, c_cnt, c_umi, c_row), num_keys=2)
    new_run = jnp.concatenate(
        [jnp.ones(1, bool),
         (shi[1:] != shi[:-1]) | (slo[1:] != slo[:-1])])
    K = L * N
    rid = _seg_ids(new_run)                  # run id per sorted row
    z = jnp.uint32(0)
    val = shi != U32_MAX
    cnt_v = jnp.where(val, scnt, z)
    # per-run lex TOP-2 of (cnt, umi) via segment reductions (NOT an
    # associative scan: tuple-carry scans at 12N rows blow up the
    # compiled graph and its compile time).
    # Each member's best NEIGHBOR is the run max, or the second max when
    # the member itself uniquely holds the max; exact-duplicate rows
    # share (cnt, umi) so a duplicated max falls back to itself, which
    # can never strictly beat itself — harmless.
    m1c = jax.ops.segment_max(cnt_v, rid, num_segments=K)
    at_m1c = cnt_v == m1c[rid]
    m1u = jax.ops.segment_max(jnp.where(at_m1c, sumi, z), rid,
                              num_segments=K)
    is_m1 = at_m1c & (sumi == m1u[rid]) & val
    n_m1 = jax.ops.segment_sum(is_m1.astype(jnp.int32), rid,
                               num_segments=K)
    # second-best: max over rows that are not THE max row
    m2c = jax.ops.segment_max(jnp.where(is_m1, z, cnt_v), rid,
                              num_segments=K)
    at_m2c = (cnt_v == m2c[rid]) & ~is_m1
    m2u = jax.ops.segment_max(jnp.where(at_m2c, sumi, z), rid,
                              num_segments=K)
    self_is_unique_max = is_m1 & (n_m1[rid] == 1)
    cand_c = jnp.where(self_is_unique_max, m2c[rid], m1c[rid])
    cand_u = jnp.where(self_is_unique_max, m2u[rid], m1u[rid])
    cand_c = jnp.where(val, cand_c, z)
    cand_u = jnp.where(val, cand_u, z)
    # fold the L per-position candidates back to their origin row:
    # count major first, then umi among candidates at that count
    owner = srow.astype(jnp.int32)
    best_c = jnp.zeros(N, jnp.uint32).at[owner].max(cand_c)
    at_max = cand_c == best_c[owner]
    best_u = jnp.zeros(N, jnp.uint32).at[owner].max(
        jnp.where(at_max, cand_u, z))
    ocnt = cnt.astype(jnp.uint32)
    take_mut = (best_c > ocnt) | ((best_c == ocnt) & (best_u > umi_s))
    best_umi = jnp.where(take_mut, best_u, umi_s)
    corr_umi = jnp.where(valid_s, best_umi, sent)             # per-row (via triple)
    is_corrected = corr_umi != umi_s

    # ---- phase 2+3: low-support determination on intermediate counts ----
    # Intermediate multiset after moving ONE read per corrected triple:
    # entry A = (bc, raw_umi, gene, c - corrected) ; entry B = (bc, corr_umi,
    # gene, corrected ? 1 : 0). Only representative rows contribute.
    corr_r = is_corrected & is_repr
    cntA = jnp.where(is_repr, cnt - corr_r.astype(jnp.int32), 0)
    cntB = jnp.where(corr_r, 1, 0)
    e_bc = jnp.concatenate([jnp.where(is_repr, bc_s, sent),
                            jnp.where(corr_r, bc_s, sent)])
    e_umi = jnp.concatenate([jnp.where(is_repr, umi_s, sent),
                             jnp.where(corr_r, corr_umi, sent)])
    e_gene = jnp.concatenate([jnp.where(is_repr, gene_s, sent),
                              jnp.where(corr_r, gene_s, sent)])
    e_cnt = jnp.concatenate([cntA, cntB])
    E = 2 * N
    eb, eu, eg, ec = jax.lax.sort((e_bc, e_umi, e_gene, e_cnt), num_keys=3)
    evalid = eb != sent
    e_new3 = jnp.concatenate(
        [jnp.ones(1, bool),
         (eb[1:] != eb[:-1]) | (eu[1:] != eu[:-1]) | (eg[1:] != eg[:-1])])
    e_t3 = _seg_ids(e_new3)
    merged = jax.ops.segment_sum(jnp.where(evalid, ec, 0), e_t3, num_segments=E)
    e_new2 = jnp.concatenate(
        [jnp.ones(1, bool), (eb[1:] != eb[:-1]) | (eu[1:] != eu[:-1])])
    e_t2 = _seg_ids(e_new2)
    mc = merged[e_t3]                         # merged count at each entry row
    is_e_repr = e_new3 & evalid
    seg_max = jax.ops.segment_max(
        jnp.where(is_e_repr, mc, -1), e_t2, num_segments=E)
    seg_n_at_max = jax.ops.segment_sum(
        (is_e_repr & (mc == seg_max[e_t2])).astype(jnp.int32),
        e_t2, num_segments=E)
    tie = seg_n_at_max[e_t2] >= 2
    low = evalid & (tie | (mc < seg_max[e_t2]))  # per entry row; same per triple

    # distinct-entry-triple table for the join: keys (bc, umi, gene) at
    # representative entries. The table is already sorted in that order.
    tb = jnp.where(is_e_repr, eb, sent)
    tu = jnp.where(is_e_repr, eu, sent)
    tg = jnp.where(is_e_repr, eg, sent)
    # compact ordering preserved (sentinels only where duplicates/invalid —
    # non-representative rows break sortedness; re-sort to be safe)
    tb, tu, tg, tlow = jax.lax.sort((tb, tu, tg, low.astype(jnp.int32)), num_keys=3)

    # ---- phase 4: per original triple, is corrected key low-support? ----
    # sort-join (same pattern as phase 1: sequential passes, no binary-
    # search gather rounds): table rows tag 0, query rows tag 1
    K2 = E + N
    jb = jnp.concatenate([tb, bc_s])
    ju = jnp.concatenate([tu, corr_umi])
    jg = jnp.concatenate([tg, gene_s])
    jtag = jnp.concatenate([jnp.zeros(E, jnp.uint32),
                            jnp.ones(N, jnp.uint32)])
    jlow = jnp.concatenate([tlow.astype(jnp.uint32),
                            jnp.zeros(N, jnp.uint32)])
    jpay = jnp.concatenate([jnp.zeros(E, jnp.uint32),
                            jnp.arange(N, dtype=jnp.uint32)])
    jb2, ju2, jg2, jt2, jl2, jp2 = jax.lax.sort(
        (jb, ju, jg, jtag, jlow, jpay), num_keys=4)
    ar2 = jnp.arange(K2, dtype=jnp.int32)
    new2 = jnp.concatenate(
        [jnp.ones(1, bool),
         (jb2[1:] != jb2[:-1]) | (ju2[1:] != ju2[:-1])
         | (jg2[1:] != jg2[:-1])])
    run_start2 = cummax(jnp.where(new2, ar2, 0))
    posf2 = cummax(jnp.where(jt2 == 0, ar2, -1))
    got = (posf2 >= run_start2) & (jt2 == 1)
    lowv = got & (jl2[jnp.maximum(posf2, 0)] > 0)
    low_support = jnp.zeros(N, bool).at[jp2.astype(jnp.int32)].max(
        jnp.where(jt2 == 1, lowv, False))
    low_support = jnp.where(valid_s, low_support, False)

    # ---- phase 5: final molecule table by (bc, gene, corrected umi) ----
    fb, fg, fu, fcnt, flow = jax.lax.sort(
        (bc_s, gene_s, corr_umi, jnp.where(is_repr, cnt, 0),
         low_support.astype(jnp.int32)),
        num_keys=3)
    fvalid = fb != sent
    f_new = jnp.concatenate(
        [jnp.ones(1, bool),
         (fb[1:] != fb[:-1]) | (fg[1:] != fg[:-1]) | (fu[1:] != fu[:-1])])
    fid = _seg_ids(f_new)
    mol_reads = jax.ops.segment_sum(jnp.where(fvalid, fcnt, 0), fid,
                                    num_segments=N)
    mol_low = jax.ops.segment_max(jnp.where(fvalid, flow, 0), fid,
                                  num_segments=N)
    f_repr = f_new & fvalid
    mol_valid = f_repr & (mol_low[fid] == 0)
    return dict(
        mol_bc=fb, mol_gene=fg, mol_umi=fu,
        mol_reads=mol_reads[fid], mol_valid=mol_valid,
        n_molecules=mol_valid.sum(),
        # raw-triple view (sorted by (bc, gene, raw umi)): the correction map
        # and low-support flags per distinct raw key, used downstream for BAM
        # UB tags, xf dup marking, and the highly-corrected-reads aggregate
        # signal (reads per raw triple at representative rows).
        raw_bc=bc_s, raw_gene=gene_s, raw_umi=umi_s,
        raw_corr_umi=corr_umi, raw_low=low_support, raw_is_repr=is_repr,
        raw_reads=jnp.where(is_repr, cnt, 0),
    )
