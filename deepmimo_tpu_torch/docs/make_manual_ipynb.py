"""Generate manual.ipynb from manual.md (this folder).

The markdown manual is the source of truth and the notebook is generated
from it: prose becomes markdown cells, ```python fences become code
cells, so the two cannot drift (tests/test_torch_docs.py holds the
committed notebook to a fresh build).

Run:  python deepmimo_tpu_torch/docs/make_manual_ipynb.py
"""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "manual.md")
DST = os.path.join(HERE, "manual.ipynb")


def md_to_cells(text: str):
    """Split markdown into (cell_type, source) pairs on python fences."""
    cells = []
    buf = []
    in_code = False
    for line in text.splitlines():
        if not in_code and line.strip().startswith("```python"):
            if any(s.strip() for s in buf):
                cells.append(("markdown", buf))
            buf = []
            in_code = True
        elif in_code and line.strip() == "```":
            cells.append(("code", buf))
            buf = []
            in_code = False
        else:
            buf.append(line)
    if any(s.strip() for s in buf):
        cells.append(("markdown" if not in_code else "code", buf))
    return cells


def build_notebook(text: str) -> dict:
    nb_cells = []
    for kind, lines in md_to_cells(text):
        src = [ln + "\n" for ln in lines]
        while src and src[-1].strip() == "":
            src.pop()
        if not src:
            continue
        cell = {"cell_type": kind, "metadata": {}, "source": src}
        if kind == "code":
            cell.update(execution_count=None, outputs=[])
        nb_cells.append(cell)
    return {
        "cells": nb_cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main():
    with open(SRC) as f:
        nb = build_notebook(f.read())
    with open(DST, "w") as f:
        json.dump(nb, f, indent=1)
        f.write("\n")
    n_code = sum(1 for c in nb["cells"] if c["cell_type"] == "code")
    print(f"wrote {DST}: {len(nb['cells'])} cells ({n_code} code)")


if __name__ == "__main__":
    main()
