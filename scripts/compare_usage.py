#!/usr/bin/env python3
"""Compare the per-device-kernel usage lines that `scripts/ab_kernels.py` prints for the parent
and the change (registers, spill bytes, CTAs an SM, SASS instructions, loop bodies).

    python3 scripts/compare_usage.py <ab_kernels log> [KERNEL=NEW_PARAMS ...]

A change that appends a template parameter with a default to a kernel gives its existing
instances one more template argument; `KERNEL=N` names such a kernel and the number of
arguments it gained, so that a change instance whose trailing N arguments are all `false` or
`0` is matched to the parent instance without them (to the plain name where the parent's kernel
was no template). Prints every parent instance whose usage
moved, every instance the change adds, and a summary line; exits 1 if a parent instance moved
or is missing."""

import re
import sys

LINE = re.compile(r"usage (\S+): (.+): (\d+) registers, (\d+) B spill, (\d+) CTAs/SM, "
                  r"(\S+) SASS instructions, loop bodies (.*)$")


def main():
    log, extra = sys.argv[1], dict(a.split("=") for a in sys.argv[2:])
    sides = {}
    for line in open(log):
        m = LINE.match(line.strip())
        if m:
            sides.setdefault(m[1], {})[m[2]] = m.groups()[2:]
    parent, change = sides["parent"], sides["change"]
    mapped = {}
    for name, usage in change.items():
        base, _, args = name.partition("<")
        n = int(extra.get(base, 0))
        if n and args:
            vals = args[:-1].split(", ")
            if all(v in ("false", "0") for v in vals[-n:]):
                # a kernel that was no template before: its name alone
                name = f"{base}<{', '.join(vals[:-n])}>" if vals[:-n] else base
        mapped.setdefault(name, usage)
    moved = [k for k in parent if k in mapped and mapped[k] != parent[k]]
    missing = [k for k in parent if k not in mapped]
    added = sorted(set(mapped) - set(parent))
    for k in moved:
        print(f"moved {k}: parent {parent[k]} change {mapped[k]}")
    for k in missing:
        print(f"missing {k}")
    for k in added:
        print(f"added {k}: {mapped[k]}")
    print(f"{len(parent)} parent instances: {len(parent) - len(moved) - len(missing)} unchanged, "
          f"{len(moved)} moved, {len(missing)} missing; {len(added)} added")
    return 1 if moved or missing else 0


if __name__ == "__main__":
    sys.exit(main())
