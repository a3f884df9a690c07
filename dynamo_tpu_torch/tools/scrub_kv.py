"""Offline scrub of a G3 disk-tier file and its manifest (a copy of the
JAX package's tools/scrub_kv.py; the file and manifest are either
package's, as both write the same layout).

Run against a detached KV disk tier (engine stopped, or a copied
snapshot) before reattaching it to a worker:

  python -m dynamo_tpu_torch.tools.scrub_kv /data/kv-g3.mmap
  python -m dynamo_tpu_torch.tools.scrub_kv /data/kv-g3.mmap \\
      --manifest /data/other.manifest
  python -m dynamo_tpu_torch.tools.scrub_kv /data/kv-g3.mmap --json

Every live manifest entry is re-checksummed against the backing file
(kv_integrity.page_checksum over page bytes + scale sidecar) and
reported as one of:

  verified   bytes match the journaled crc: prefix-hittable on attach
  corrupt    crc mismatch (bit rot, torn page write): an eager
             ``--scrub-on-start`` attach drops it as a miss
  orphaned   journal damage: torn or unparseable lines, entries with
             out-of-range or colliding slots: dropped at attach

Exit status: 0 all clean, 1 corruption found (corrupt > 0), 2 the file
or manifest could not be read at all. The tier's geometry comes from the
manifest's meta line, so the tool needs no engine config.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from dynamo_tpu_torch.engine.offload import (
    _DTYPE_NAME,
    _MMAP_DTYPE,
    DiskOffloadTier,
)
from dynamo_tpu_torch.kv_integrity import page_checksum

# the manifest's dtype name -> the tier's torch dtype
_BY_NAME = {name: dt for dt, name in _DTYPE_NAME.items()}


def scrub(path: str, manifest_path: str) -> dict:
    meta, live, torn = DiskOffloadTier.load_manifest(manifest_path)
    report = {
        "path": path, "manifest": manifest_path,
        "entries": len(live), "verified": 0, "corrupt": 0,
        "orphaned": torn, "corrupt_hashes": [],
    }
    if meta is None:
        # no geometry line: nothing is checkable, every entry is journal
        # damage
        report["orphaned"] += len(live)
        return report
    num_pages = int(meta["num_pages"])
    page_shape = tuple(meta["page_shape"])
    tdtype = _BY_NAME[meta["dtype"]]
    # the file's element type (bf16 is stored as its raw 2-byte words)
    fdtype = np.dtype(_MMAP_DTYPE[tdtype])
    scale_shape = tuple(meta.get("scale_shape") or ())
    pool_shape = (page_shape[0], page_shape[1], page_shape[2],
                  num_pages, page_shape[3], page_shape[4])
    nbytes = int(np.prod(pool_shape)) * fdtype.itemsize
    size = os.path.getsize(path)
    raw = np.memmap(path, dtype=fdtype, mode="r",
                    shape=pool_shape if size >= nbytes else None)
    if size < nbytes:
        # a truncated file: pad a dense copy with zeros so short slots
        # fail their crc (reported corrupt) instead of crashing
        flat = np.zeros(nbytes // fdtype.itemsize, fdtype)
        flat[: raw.shape[0]] = raw
        raw = flat.reshape(pool_shape)
    used: set[int] = set()
    for h, (slot, _parent, crc, scale) in live.items():
        if not (0 <= slot < num_pages) or slot in used:
            report["orphaned"] += 1
            continue
        used.add(slot)
        scale_t = None
        if scale_shape:
            if scale is None or len(scale) != int(np.prod(scale_shape)):
                report["orphaned"] += 1
                continue
            scale_t = torch.tensor(scale, dtype=torch.float32).reshape(
                scale_shape)
        # one page copied out of the read-only map
        page = torch.from_numpy(np.ascontiguousarray(raw[:, :, :, slot]))
        if page_checksum(page.view(tdtype), scale_t) == crc:
            report["verified"] += 1
        else:
            report["corrupt"] += 1
            report["corrupt_hashes"].append(int(h))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.tools.scrub_kv",
        description=__doc__.splitlines()[0])
    ap.add_argument("path", help="G3 backing file (the mmap pool)")
    ap.add_argument("--manifest", default=None,
                    help="sidecar manifest (default: <path>.manifest)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    manifest = args.manifest or args.path + ".manifest"
    if not os.path.exists(args.path):
        print(f"error: no such file: {args.path}", file=sys.stderr)
        return 2
    if not os.path.exists(manifest):
        print(f"error: no manifest at {manifest} (a manifest-less tier "
              "cannot be scrubbed: it has no journaled checksums)",
              file=sys.stderr)
        return 2
    try:
        report = scrub(args.path, manifest)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"error: scrub failed: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(f"{report['path']}: {report['entries']} manifest entries "
              f"-> {report['verified']} verified, "
              f"{report['corrupt']} corrupt, "
              f"{report['orphaned']} orphaned")
        for h in report["corrupt_hashes"][:20]:
            print(f"  corrupt block hash {h}")
    return 1 if report["corrupt"] else 0


if __name__ == "__main__":
    sys.exit(main())
