"""Every ROADMAP item the port cites exists in ROADMAP.md.

The port's ``NotImplementedError`` messages and docstrings name the
ROADMAP item that will honour what they leave out ("Queue A item 12f",
"Queue C item R2"), and the tests of each raise check that label. A
re-anchor that renames or splits an item must keep every cited anchor;
this test names the first one it dropped, in one place.
"""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROADMAP = (ROOT / "ROADMAP.md").read_text()
PACKAGE = ROOT / "flink_tpu_torch"

#: "Queue A item 12f" / "Queue C item R2", across a line break too
CITE = re.compile(r"Queue\s+([AC])\s+item\s+(\w+(?:-\d+)?)")


def _citations():
    found = {}
    for path in sorted(PACKAGE.rglob("*.py")):
        text = path.read_text()
        for m in CITE.finditer(text):
            if m.group(2) in ("{item}", "item"):
                continue
            line = text.count("\n", 0, m.start()) + 1
            found.setdefault((m.group(1), m.group(2)), []).append(
                f"{path.relative_to(ROOT)}:{line}")
    return found


def _anchored(queue: str, label: str) -> bool:
    if queue == "A":
        return f"**Item {label} " in ROADMAP
    # Queue C: "**Item 15: ..." or a reference caveat "**R2. ..."
    return (f"**Item {label}:" in ROADMAP or f"**Item {label} " in ROADMAP
            or f"**{label}. " in ROADMAP)


CITED = _citations()


def test_the_package_cites_roadmap_items():
    assert ("A", "12h") in CITED
    assert ("C", "R2") in CITED


@pytest.mark.parametrize("queue,label", sorted(CITED),
                         ids=[f"{q}-{l}" for q, l in sorted(CITED)])
def test_every_cited_item_has_its_anchor(queue, label):
    assert _anchored(queue, label), (
        f"Queue {queue} item {label} is cited at "
        f"{', '.join(CITED[(queue, label)])} but ROADMAP.md has no anchor "
        "for it")


def test_the_item_12_anchor_stays():
    """The sub-items 12a-12h refine item 12; the tests of older raises
    read the bare label too."""
    assert "**Item 12 " in ROADMAP
    for sub in "abcdefgh":
        assert f"**Item 12{sub} " in ROADMAP, sub
