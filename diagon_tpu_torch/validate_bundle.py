"""Index integrity validator: the port's copy of ``tools/validate_bundle.py``
(the reference's LuceneFormatValidator role, ``tools/LuceneFormatValidator.cpp``:
open an index, exercise every reader, report failures), over the port's
store, commit files and postings decoder, with the same checks and the same
report.

Usage: python -m diagon_tpu_torch.validate_bundle <index_dir> [--deep]

Checks: commit manifest parses; every segment bundle opens with checksums
verified; postings decode (every block round-trips through the numpy
decoder with in-range ascending docids); norms/positions/doc-values/points
shapes are consistent; live-docs bitmaps sized correctly. --deep also
cross-checks decode_all_numpy against per-block decode.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from diagon_tpu_torch.codecs.postings import decode_all_numpy, decode_block_numpy
from diagon_tpu_torch.index.writer import find_latest_commit_gen, read_segment_infos
from diagon_tpu_torch.store import FSDirectory, read_segment


def fail(msg):
    print(f"  FAIL: {msg}")
    return 1


def validate(path: str, deep: bool = False) -> int:
    """Print the report of the index at ``path``; 0 when it is sound."""
    d = FSDirectory(path)
    errors = 0
    gen = find_latest_commit_gen(d)
    if gen is None:
        print("no commit generation found")
        return 1
    infos = read_segment_infos(d, gen)
    print(f"commit generation {gen}: {len(infos.segments)} segment(s), "
          f"{infos.total_docs()} docs")

    for si in infos.segments:
        print(f"segment {si.name} ({si.num_docs} docs):")
        try:
            seg = read_segment(d, si.name, verify_checksums=True)
        except Exception as e:
            errors += fail(f"bundle read: {e}")
            continue
        print("  checksums OK")
        if seg.num_docs != si.num_docs:
            errors += fail(
                f"doc count mismatch: bundle {seg.num_docs} vs manifest {si.num_docs}"
            )
        if seg.live_docs is not None:
            if len(seg.live_docs) != seg.num_docs:
                errors += fail("live docs bitmap length mismatch")
            dels = seg.num_docs - int(seg.live_docs.sum())
            if dels != si.del_count:
                errors += fail(
                    f"del count mismatch: {dels} vs manifest {si.del_count}"
                )

        for fname, fd in seg.fields.items():
            pp = fd.postings
            if len(fd.norms) != seg.num_docs:
                errors += fail(f"{fname}: norms length")
            n_bad = 0
            total_df = 0
            for tid in range(pp.num_terms):
                docs_parts = []
                for b in range(
                    int(pp.block_start[tid]), int(pp.block_start[tid + 1])
                ):
                    docs, freqs = decode_block_numpy(pp, b)
                    docs_parts.append(docs)
                    if (freqs < 1).any():
                        n_bad += 1
                docs = (
                    np.concatenate(docs_parts)
                    if docs_parts
                    else np.zeros(0, np.int64)
                )
                total_df += len(docs)
                if len(docs) != pp.doc_freq[tid]:
                    n_bad += 1
                if len(docs) and (
                    docs.min() < 0
                    or docs.max() >= seg.num_docs
                    or (np.diff(docs) <= 0).any()
                ):
                    n_bad += 1
            if n_bad:
                errors += fail(f"{fname}: {n_bad} term postings invalid")
            else:
                print(f"  field {fname!r}: {pp.num_terms} terms, "
                      f"{total_df} postings OK")
            if deep:
                alld, allf = decode_all_numpy(pp)
                pos = 0
                ok = True
                for tid in range(pp.num_terms):
                    for b in range(
                        int(pp.block_start[tid]), int(pp.block_start[tid + 1])
                    ):
                        docs, freqs = decode_block_numpy(pp, b)
                        if not (
                            (alld[pos : pos + len(docs)] == docs).all()
                            and (allf[pos : pos + len(docs)] == freqs).all()
                        ):
                            ok = False
                        pos += len(docs)
                if not ok:
                    errors += fail(f"{fname}: vectorized decode mismatch")
                else:
                    print(f"  field {fname!r}: deep decode cross-check OK")

        for fname, dv in seg.doc_values.items():
            if len(dv.docs) != len(dv.values) and dv.value_start is None:
                errors += fail(f"dv {fname}: docs/values length")
        for fname, pt in seg.points.items():
            if (np.diff(pt.values) < 0).any():
                errors += fail(f"points {fname}: values not sorted")

    print("RESULT:", "OK" if errors == 0 else f"{errors} error(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("index_dir")
    ap.add_argument("--deep", action="store_true")
    args = ap.parse_args()
    sys.exit(validate(args.index_dir, args.deep))
