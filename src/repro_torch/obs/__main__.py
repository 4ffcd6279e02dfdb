"""CLI front door: `python -m repro_torch.obs summarize trace.json ...`."""
from __future__ import annotations

import sys

from repro_torch.obs.summarize import main as summarize_main


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.obs summarize TRACE.json "
              "[--top N] [--min-coverage X]", file=sys.stderr)
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "summarize":
        return summarize_main(rest)
    print(f"repro_torch.obs: unknown command {cmd!r} (expected 'summarize')",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
