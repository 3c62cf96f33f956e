#!/usr/bin/env python
"""The port's dry-run records beside the reference's, cell by cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --out build/dryrun_torch
    PYTHONPATH=src python -m repro.launch.dryrun --mesh single \\
        --out build/dryrun_ref
    python scripts/dryrun_compare.py build/dryrun_torch build/dryrun_ref

reads the ``<arch>__<shape>__<mesh>.json`` records (and ``.failed``
files) of two dry-run output directories, the port's first, and prints one
markdown row a cell: per-device FLOPs, argument bytes and collective bytes
of both and the port's over the reference's, and each side's trace or
lower-plus-compile seconds.  These are counts, not times.  A cell that
failed on a side, or has no record there, is named with the last line of
its traceback.  ``--json`` prints one JSON line a cell instead;
``--by-arch`` one markdown row an architecture, a cell a shape:
``F`` port / reference FLOPs, ``A`` the port's argument bytes less the
reference's (``=`` when equal), ``C`` port / reference collective bytes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def _records(root: str) -> tuple[dict, dict]:
    """({tag: record}, {tag: last traceback line}) of a directory."""
    recs, failed = {}, {}
    for path in glob.glob(os.path.join(root, "*.json")):
        with open(path) as f:
            recs[os.path.basename(path)[:-len(".json")]] = json.load(f)
    for path in glob.glob(os.path.join(root, "*.json.failed")):
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        failed[os.path.basename(path)[:-len(".json.failed")]] = (
            lines[-1] if lines else "")
    return recs, failed


def _ratio(a, b):
    return a / b if b else None


def rows(port_dir: str, ref_dir: str) -> list:
    port, port_failed = _records(port_dir)
    ref, ref_failed = _records(ref_dir)
    out = []
    for tag in sorted(set(port) | set(ref) | set(port_failed)
                      | set(ref_failed)):
        p, r = port.get(tag), ref.get(tag)
        row = {"cell": tag,
               "port_failed": port_failed.get(tag) if p is None else None,
               "ref_failed": ref_failed.get(tag) if r is None else None}
        if p is not None and r is not None:
            row.update({
                "flops": (p["flops_per_device"], r["flops_per_device"]),
                "argument_bytes": (p["memory"]["argument_bytes"],
                                   r["memory"]["argument_bytes"]),
                "collective_bytes": (p["collectives"]["total_bytes"],
                                     r["collectives"]["total_bytes"]),
                "seconds": (p["lower_s"] + p["compile_s"],
                            r["lower_s"] + r["compile_s"])})
        out.append(row)
    return out


def _fmt(x) -> str:
    return "-" if x is None else f"{x:.4g}"


def markdown(table: list) -> str:
    lines = ["| cell | FLOPs port / ref (ratio) | argument B port / ref | "
             "collective B port / ref | s port / ref |",
             "|---|---|---|---|---|"]
    for row in table:
        if "flops" not in row:
            why = "; ".join(f"{side} failed: {row[k]}" for side, k in
                            (("port", "port_failed"), ("ref", "ref_failed"))
                            if row[k] is not None) or "no record"
            lines.append(f"| {row['cell']} | {why} | | | |")
            continue
        f, a, c, s = (row[k] for k in ("flops", "argument_bytes",
                                       "collective_bytes", "seconds"))
        lines.append(
            f"| {row['cell']} | {_fmt(f[0])} / {_fmt(f[1])} "
            f"({_fmt(_ratio(*f))}) | {a[0]} / {a[1]} | {_fmt(c[0])} / "
            f"{_fmt(c[1])} | {s[0]:.2f} / {s[1]:.2f} |")
    return "\n".join(lines)


def by_arch(table: list) -> str:
    """One markdown row an architecture; its cells in record order."""
    arches = {}
    for row in table:
        arch, shape, _ = row["cell"].split("__")
        if "flops" not in row:
            text = f"{shape}: failed"
        else:
            f, a, c = (row[k] for k in ("flops", "argument_bytes",
                                        "collective_bytes"))
            diff = a[0] - a[1]
            text = (f"{shape}: F {_fmt(f[0])} / {_fmt(f[1])}, A "
                    f"{'=' if not diff else f'{diff:+,}'}, C {_fmt(c[0])} "
                    f"/ {_fmt(c[1])}")
        arches.setdefault(arch, []).append(text)
    return "\n".join(f"| {arch} | " + " | ".join(cells) + " |"
                     for arch, cells in arches.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port_dir")
    ap.add_argument("ref_dir")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--by-arch", action="store_true")
    args = ap.parse_args(argv)
    table = rows(args.port_dir, args.ref_dir)
    if args.by_arch:
        print(by_arch(table))
    elif args.json:
        for row in table:
            print(json.dumps(row))
    else:
        print(markdown(table))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
