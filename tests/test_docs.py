"""Docs stay honest: every measured number in README's benchmark block
names the card and power limit it was taken on, and the parity ledger table
stays populated and passing."""

import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_readme_bench_table_populated():
    """Each measured row names the card and its power limit; a block with no
    rows must say that no run has been recorded yet."""
    text = (REPO / "README.md").read_text()
    m = re.search(r"<!-- bench:begin -->(.*?)<!-- bench:end -->", text, re.S)
    assert m, "README.md lost its bench:begin/end markers"
    body = m.group(1).strip()
    rows = [ln for ln in body.splitlines() if ln.startswith("|") and "**" in ln]
    if not rows:
        assert "no h100 run" in body.lower(), "empty bench block must say no run is recorded"
    for row in rows:
        assert re.search(r"H100.*\d+(\.\d+)? W", row), f"row lacks card/power limit: {row}"


def test_readme_has_no_hand_written_numbers_outside_block():
    # Throughput claims belong in the artifact-derived block (or docs/design.md
    # where they carry their own provenance), not hand-typed into README prose.
    text = (REPO / "README.md").read_text()
    outside = re.sub(r"<!-- bench:begin -->.*?<!-- bench:end -->", "", text, flags=re.S)
    hits = re.findall(r"\b\d+(?:\.\d+)?\s*GSNP/s", outside)
    # the capability table cites two measured kernel rates with design context;
    # anything beyond that is drift.
    assert len(hits) <= 2, f"hand-written GSNP/s claims outside bench block: {hits}"


def test_parity_ledger_table_populated():
    text = (REPO / "PARITY.md").read_text()
    m = re.search(r"<!-- parity:begin -->(.*?)<!-- parity:end -->", text, re.S)
    assert m, "PARITY.md lost its parity:begin/end markers"
    rows = [ln for ln in m.group(1).splitlines() if ln.startswith("| `")]
    assert len(rows) >= 8, f"parity ledger has only {len(rows)} measured rows"
    assert "FAIL" not in m.group(1), "PARITY.md publishes a failing parity row"


def test_parity_quick_rows_pass():
    """The closed-form half of the --parity ledger, run live (the sampler
    and REML rows are covered by test_parity_oracles.py)."""
    from genomicbreedingmodels_tpu.parity import run_parity_ledger

    rows = run_parity_ledger(emit=lambda s: None, quick=True)
    assert len(rows) >= 5
    assert all(r["pass"] for r in rows), [r for r in rows if not r["pass"]]
