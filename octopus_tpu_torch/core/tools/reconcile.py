"""Window-boundary call reconciliation.

Capability-equivalent to the reference's multithreaded
resolve_connecting_calls (src/core/octopus.cpp:950-1015): where two adjacent
task windows both produced calls over the seam, keep the RHS window's
variant calls (its reads were fetched with the seam fully in context, and
dropping LHS avoids corrupting downstream phase sets), while preferring LHS
variant calls over RHS *leading refcall blocks*, squashing a partially
overlapped RHS refcall block to its non-overlapping tail.

Operates on VcfRecord lists at shard-merge time (run.py), which is where our
window-parallel design has both sides available — the reference does the
same buffering in its ordered writer (octopus.cpp:1098-1119).
"""

from __future__ import annotations


def _rec_begin(rec) -> int:
    return rec.pos - 1


def _rec_end(rec) -> int:
    end = rec.info.get("END")
    if end is not None:
        return int(end)
    return rec.pos - 1 + len(rec.ref)


def _is_refcall(rec) -> bool:
    return not rec.alts or rec.alts in (["<NON_REF>"], ["."])


def _overlaps(rec, region) -> bool:
    b, e = region
    rb, re_ = _rec_begin(rec), _rec_end(rec)
    if rb == re_:      # insertions: empty-region overlap semantics
        return b <= rb <= e and b != e
    return rb < e and re_ > b


def _encompassing(recs) -> tuple[int, int]:
    return _rec_begin(recs[0]), max(_rec_end(r) for r in recs)


def resolve_connecting_records(lhs: list, rhs: list, fetch_base=None):
    """Resolve seam conflicts between two adjacent windows' records.

    lhs/rhs are position-sorted VcfRecord lists of the SAME contig; returns
    the (possibly trimmed) pair. fetch_base(position0) -> str supplies the
    reference base when a partially-overlapped RHS refcall block must be
    squashed to its tail (octopus.cpp:995-1009)."""
    if not lhs or not rhs:
        return lhs, rhs
    lhs_region = _encompassing(lhs)
    rhs_region = _encompassing(rhs)
    # first LHS call connecting with (overlapping) the RHS call region
    first_lhs_connecting = len(lhs)
    for i, rec in enumerate(lhs):
        if _overlaps(rec, rhs_region):
            first_lhs_connecting = i
            break
    # last RHS call connecting with the LHS call region (exclusive index)
    last_rhs_connecting = 0
    for i, rec in enumerate(rhs):
        if _overlaps(rec, lhs_region):
            last_rhs_connecting = i + 1
    first_lhs_remove = first_lhs_connecting
    # index of the first RHS variant call among the connecting records
    first_rhs_variant = next(
        (i for i in range(last_rhs_connecting) if not _is_refcall(rhs[i])),
        last_rhs_connecting)
    if first_rhs_variant > 0:
        # RHS leads with refcall blocks: prefer LHS variant calls there
        if first_rhs_variant < len(rhs):
            ref_block_end = _rec_begin(rhs[first_rhs_variant])
            rhs_keep_region = (max(ref_block_end, rhs_region[0]),
                               rhs_region[1])
        else:
            rhs_keep_region = rhs_region
        first_lhs_remove = next(
            (i for i in range(first_lhs_connecting, len(lhs))
             if _overlaps(lhs[i], rhs_keep_region)), len(lhs))
        if first_lhs_remove > 0:
            lhs_keep_region = _encompassing(lhs[:first_lhs_remove])
            last_rhs_remove = next(
                (i for i in range(first_rhs_variant)
                 if not _overlaps(rhs[i], lhs_keep_region)),
                first_rhs_variant)
            if last_rhs_remove > 0:
                last_ref = rhs[last_rhs_remove - 1]
                tail_begin = lhs_keep_region[1]
                keep_tail = (_rec_end(last_ref) > tail_begin
                             and _rec_begin(last_ref) < tail_begin)
                rhs = rhs[last_rhs_remove:]
                if keep_tail:
                    # squash the partially-overlapped refcall block to its
                    # non-overlapping tail (octopus.cpp:995-1009)
                    import copy
                    squashed = copy.deepcopy(last_ref)
                    squashed.pos = tail_begin + 1
                    squashed.ref = (fetch_base(tail_begin)
                                    if fetch_base is not None else "N")
                    if _rec_end(last_ref) == tail_begin + 1:
                        squashed.info.pop("END", None)
                    rhs = [squashed] + rhs
    return lhs[:first_lhs_remove], rhs


__all__ = ["resolve_connecting_records"]
