"""Regenerate README.md's measured-benchmark table from a bench artifact.

Reads JSON metric lines (bench.py output, or a JSON artifact whose
"output"/"stdout" field holds them) and rewrites the table between the
`<!-- bench:begin -->` / `<!-- bench:end -->` markers, so README numbers are
always artifact-derived, never hand-maintained. Every row names the card and
power limit the run was taken on (`--card`, as nvidia-smi prints
`name,power.limit`).

Usage: python scripts/update_readme_bench.py --card "NAME, LIMIT W" <bench-output> ...
Later files win on duplicate metrics (pass the freshest artifact last).
"""

import json
import re
import sys
from pathlib import Path

README = Path(__file__).resolve().parent.parent / "README.md"


def parse_metrics(paths):
    metrics = {}
    for path in paths:
        text = Path(path).read_text()
        lines = []
        try:  # driver artifact: JSON object wrapping the stdout
            obj = json.loads(text)
            if isinstance(obj, dict):
                lines = str(
                    obj.get("output") or obj.get("stdout") or obj.get("tail") or ""
                ).splitlines()
                if "metric" in obj:
                    lines.append(json.dumps(obj))
        except json.JSONDecodeError:
            lines = text.splitlines()
        for ln in lines:
            ln = ln.strip()
            if not ln.startswith("{"):
                continue
            try:
                m = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(m, dict) and {"metric", "value", "unit"} <= m.keys():
                metrics[m["metric"]] = m
    return metrics


def fmt(m):
    v, u = m["value"], m["unit"]
    if u == "SNPs/s":
        return f"**{v / 1e9:.2f} GSNP/s**"
    if u == "updates/s":
        return f"**{v / 1e3:.0f}k marker-updates/s**"
    if u == "markers/s":
        return f"**{v:,.0f} markers/s**"
    if u == "pairs/s":
        return f"**{v / 1e6:.0f}M pairs/s**"
    if u == "ESS/s":
        return f"**{v:.1f} ESS/s**"
    if u == "s":
        return f"**{v:.1f} s**"
    return f"**{v} {u}**"


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--card", required=True,
                    help="nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    ap.add_argument("files", nargs="+")
    args = ap.parse_args()
    metrics = parse_metrics(args.files)
    if not metrics:
        sys.exit("no metric lines found in the given files")
    rows = "\n".join(
        f"| {name} | {fmt(m)} | {args.card} |" for name, m in sorted(metrics.items())
    )
    table = f"| benchmark (bench.py metric) | result | card, power limit |\n|---|---|---|\n{rows}"
    text = README.read_text()
    # Match the markers regardless of what sits between them (including the
    # adjacent-lines empty case); re.subn so a zero-match run is a hard error
    # instead of a silent no-op success message.
    new, count = re.subn(
        r"<!-- bench:begin -->.*?<!-- bench:end -->",
        lambda _mo: f"<!-- bench:begin -->\n{table}\n<!-- bench:end -->",
        text,
        flags=re.S,
    )
    if count == 0:
        sys.exit("README.md has no <!-- bench:begin/end --> markers")
    README.write_text(new)
    print(f"README.md: wrote {len(metrics)} artifact-derived rows")


if __name__ == "__main__":
    main()
