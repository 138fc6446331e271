#!/usr/bin/env python
"""Convert a span JSONL event log of the PyTorch port into Chrome
trace_event JSON.

The port's obs layer writes spans either directly as a Chrome trace
(`repro_torch.obs.write_chrome_trace`) or as a flat JSONL log
(`write_jsonl`) when the consumer wants grep-able records. This converts
the latter into the former so any JSONL capture can be opened in Perfetto:

    python tools/torch_trace2chrome.py spans.jsonl trace.json
    # then load trace.json at https://ui.perfetto.dev (or chrome://tracing)

It reads and writes files only, so it needs no device.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.obs.export import read_jsonl, write_chrome_trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Span JSONL -> Chrome trace_event JSON (Perfetto).")
    ap.add_argument("jsonl", help="span event log (obs.export.write_jsonl)")
    ap.add_argument("out", help="Chrome trace JSON output path")
    args = ap.parse_args(argv)

    records = read_jsonl(args.jsonl)
    if not records:
        print(f"error: no span records in {args.jsonl}", file=sys.stderr)
        return 1
    write_chrome_trace(records, args.out)
    print(f"wrote {len(records)} spans -> {args.out} "
          f"(load in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
