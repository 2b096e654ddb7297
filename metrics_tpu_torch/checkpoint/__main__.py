"""``python -m metrics_tpu_torch.checkpoint`` — operate on snapshot directories.

Counterpart of ``python -m metrics_tpu.checkpoint``, with its subcommands
and output.

Subcommands::

    inspect <root> [--step N]     # manifest summary: members, leaves, shards
    verify  <root> [--step N|--all]  # checksum + structural verification
    merge   <root> <out_root> [--step N]  # offline N-shard -> 1-shard fold
    clean   <root>                # reap aborted .pending directories

All subcommands are manifest/payload-level: they never instantiate metric
classes, so they work on checkpoints from any metric without importing its
package (and touch no accelerator).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from metrics_tpu_torch.checkpoint import io as _io
from metrics_tpu_torch.checkpoint.format import SELF_KEY
from metrics_tpu_torch.checkpoint.restore import merge_shards, verify_all, verify_checkpoint


def _cmd_inspect(root: str, step: Optional[int]) -> int:
    try:
        step = _io.resolve_step(root, step)
        manifest = _io.read_manifest(root, step)
    except _io.CheckpointError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    print(f"root:        {root}")
    print(f"step:        {step}")
    print(f"kind:        {manifest['kind']}")
    print(f"world_size:  {manifest['world_size']}")
    print(f"format:      v{manifest['format_version']}")
    all_steps = _io.available_steps(root)
    print(f"steps here:  {', '.join(str(s) for s in all_steps)}")
    total_bytes = sum(int(s["bytes"]) for s in manifest["shards"])
    print(f"payload:     {len(manifest['shards'])} shard(s), {total_bytes} bytes total")
    first = manifest["shards"][0]
    fp_members = (manifest.get("fingerprint") or {}).get("members", {})
    for member_key, mmeta in first["members"].items():
        label = "(metric)" if member_key == SELF_KEY else member_key
        cls = fp_members.get(member_key, {}).get("class", "?")
        counts = [int(s["members"][member_key]["update_count"]) for s in manifest["shards"]]
        print(f"  {label} [{cls}]: update_count={sum(counts)} ({'+'.join(str(c) for c in counts)})")
        for name, leaf in mmeta["leaves"].items():
            kind = leaf["kind"]
            if kind == "array":
                detail = f"{leaf['dtype']}{tuple(leaf['shape'])}"
            elif kind == "list":
                detail = f"length={leaf['length']}"
            else:
                detail = f"count={leaf.get('count', 0)}/capacity={leaf['capacity']}"
            print(f"    {name}: {kind} reduce={leaf['reduction']} {detail}")
    return 0


def _print_report(report) -> None:
    status = "OK" if report.ok else "FAIL"
    print(f"step {report.step}: {status} ({report.shards} shard(s), world_size={report.world_size})")
    for issue in report.issues:
        print(f"  - {issue}")


def _cmd_verify(root: str, step: Optional[int], check_all: bool) -> int:
    if check_all:
        reports = verify_all(root)
        if not reports:
            print(f"error: no committed checkpoint under {root!r}", file=sys.stderr)
            return 1
    else:
        reports = [verify_checkpoint(root, step)]
    for report in reports:
        _print_report(report)
    bad = [r for r in reports if not r.ok]
    if bad:
        first = bad[0]
        print(
            f"error: first corrupt step is {first.step} "
            f"({len(bad)} of {len(reports)} step(s) failed verification)",
            file=sys.stderr,
        )
        return 1
    return 0


def _cmd_merge(root: str, out_root: str, step: Optional[int]) -> int:
    try:
        out_step = merge_shards(root, out_root, step)
    except _io.CheckpointError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    print(f"merged -> {_io.step_dir(out_root, out_step)} (1 shard)")
    report = verify_checkpoint(out_root, out_step)
    _print_report(report)
    return 0 if report.ok else 1


def _cmd_clean(root: str, dry_run: bool = False) -> int:
    removed = _io.clean_pending(root, dry_run=dry_run)
    verb = "would remove" if dry_run else "removed"
    for path in removed:
        print(f"{verb} {path}")
    print(f"{len(removed)} pending dir(s) {'found' if dry_run else 'reaped'}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m metrics_tpu_torch.checkpoint",
        description="Inspect, verify, and merge metrics_tpu_torch snapshot directories.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("inspect", help="summarize a committed snapshot")
    p.add_argument("root")
    p.add_argument("--step", type=int, default=None)

    p = sub.add_parser("verify", help="checksum + structural verification")
    p.add_argument("root")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--all", action="store_true", help="verify every committed step")

    p = sub.add_parser("merge", help="fold all shards of a step into a 1-shard snapshot")
    p.add_argument("root")
    p.add_argument("out_root")
    p.add_argument("--step", type=int, default=None)

    p = sub.add_parser("clean", help="remove aborted .pending directories")
    p.add_argument("root")
    p.add_argument("--dry-run", action="store_true",
                   help="list what would be removed without touching anything")

    args = parser.parse_args(argv)
    if args.cmd == "inspect":
        return _cmd_inspect(args.root, args.step)
    if args.cmd == "verify":
        return _cmd_verify(args.root, args.step, args.all)
    if args.cmd == "merge":
        return _cmd_merge(args.root, args.out_root, args.step)
    return _cmd_clean(args.root, dry_run=args.dry_run)


if __name__ == "__main__":
    raise SystemExit(main())
