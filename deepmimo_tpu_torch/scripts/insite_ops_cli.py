"""Operational maintenance CLI for InSite scenario farms.

One dry-run-by-default tool for the farm's chores:

    deepmimo-tpu-torch-insite-ops clean-city CSV BASE [--suffix _28] [--apply]
    deepmimo-tpu-torch-insite-ops clean-sources BASE [--p2m] [--objects]
                                  [--extra-deepmimo] [--apply]
    deepmimo-tpu-torch-insite-ops move-insite-out FOLDER [FOLDER ...]
                                  [--apply]
    deepmimo-tpu-torch-insite-ops rename-param-key [--root DIR]
                                  [--old txrx] [--new txrx_sets] [--apply]
    deepmimo-tpu-torch-insite-ops zoom-image INPUT OUTPUT [--zoom 1.5]

Every mutating subcommand prints its plan and touches nothing unless
``--apply`` is given. ``rename-param-key`` defaults to the port's
``config['scenarios_folder']``; ``zoom-image`` needs Pillow. Copied from
``deepmimo_tpu/scripts/insite_ops_cli.py``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import shutil
import sys
from typing import List


def _act(apply: bool, msg: str, fn=None) -> None:
    print(("" if apply else "[dry-run] ") + msg)
    if apply and fn is not None:
        fn()


def _delete(path: str, apply: bool) -> None:
    if os.path.isdir(path):
        _act(apply, f"delete dir  {path}", lambda: shutil.rmtree(path))
    else:
        _act(apply, f"delete file {path}", lambda: os.remove(path))


# ---------------------------------------------------------------------------
# move-insite-out: hoist an 'insite*' subfolder's contents one level up
# ---------------------------------------------------------------------------

def move_insite_out(folder: str, apply: bool = False) -> bool:
    """Move the contents of ``folder/insite*/`` into ``folder`` and drop
    the then-empty subfolder. Returns True when an insite folder existed."""
    subs = [os.path.join(folder, d) for d in sorted(os.listdir(folder))
            if d.startswith("insite")
            and os.path.isdir(os.path.join(folder, d))]
    if not subs:
        print(f"no insite subfolder in {folder}")
        return False
    insite = subs[0]
    for item in sorted(os.listdir(insite)):
        src = os.path.join(insite, item)
        dst = os.path.join(folder, item)
        _act(apply, f"move {src} -> {dst}", lambda s=src, d=dst:
             shutil.move(s, d))
    _act(apply, f"remove empty {insite}", lambda: os.rmdir(insite))
    return True


# ---------------------------------------------------------------------------
# clean-city: normalize ray-tracing output folders named by GPS bbox
# ---------------------------------------------------------------------------

def bbox_folder_pattern(row: dict) -> str:
    """`bbox_*<minlat>_<minlon>_<maxlat>_<maxlon>*` with '.' -> '-'
    (the OSM pipeline's folder naming)."""
    key = "_".join(str(row[k]) for k in ("bbox_minlat", "bbox_minlon",
                                         "bbox_maxlat", "bbox_maxlon"))
    return f"bbox_*{key.replace('.', '-')}*"


def clean_city_folders(csv_path: str, base: str, suffix: str = "",
                       apply: bool = False) -> int:
    """For each CSV row (columns: name, bbox_minlat/minlon/maxlat/maxlon):
    find the matching ``bbox_*`` folder, strip everything except the
    ``insite_*`` payload, rename it to ``<name><suffix>``, hoist the
    insite contents, and drop intermediates. Returns folders processed."""
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    done = 0
    for row in rows:
        matches = sorted(glob.glob(os.path.join(
            base, bbox_folder_pattern(row))))
        if not matches:
            print(f"WARNING: no folder matches {bbox_folder_pattern(row)}")
            continue
        folder = matches[0]
        for item in sorted(os.listdir(folder)):
            if item.startswith("insite"):
                continue
            _delete(os.path.join(folder, item), apply)
        target = os.path.join(base, row["name"].lower() + suffix)
        _act(apply, f"rename {folder} -> {target}",
             lambda s=folder, d=target: os.rename(s, d))
        work = target if apply else folder
        move_insite_out(work, apply=apply)
        for item in ("intermediate_files", "study_area_mat",
                     "parameters.txt"):
            p = os.path.join(work, item)
            if os.path.exists(p):
                _delete(p, apply)
        done += 1
    return done


# ---------------------------------------------------------------------------
# clean-sources: prune InSite project folders down to what the converter
# needs (.setup/.txrx/.xml + .paths/.pl p2m outputs + referenced geometry)
# ---------------------------------------------------------------------------

def _xml_referenced_geometry(xml_path: str) -> List[str]:
    exts = (".city", ".ter", ".veg", ".flp", ".object")
    refs = []
    with open(xml_path) as f:
        for line in f:
            line = line.strip()
            if any(line.endswith(e + '"/>') for e in exts):
                if m := re.search(r'Value="\./([^"]*)"', line):
                    refs.append(m.group(1))
    return refs


def clean_source_files(base: str, apply: bool = False,
                       extra_deepmimo: bool = False, p2m: bool = True,
                       objects: bool = False) -> None:
    """Prune each project subfolder of ``base``:

    - ``extra_deepmimo``: drop stale ``*_deepmimo`` conversion folders
      when a project has more than one subfolder;
    - stray ``.diag`` files whose basename differs from the project xml;
    - ``p2m``: study-area files that are neither ``.paths.`` nor
      ``.pl.`` outputs (the only ones the converter reads);
    - ``objects``: geometry files not referenced by the project xml.
    """
    for sub in sorted(f.path for f in os.scandir(base) if f.is_dir()):
        subdirs = sorted(f.path for f in os.scandir(sub) if f.is_dir())
        if extra_deepmimo and len(subdirs) > 1:
            for d in subdirs:
                if d.endswith("_deepmimo"):
                    _delete(d, apply)
        xmls = sorted(f.path for f in os.scandir(sub)
                      if f.name.endswith(".xml"))
        if xmls:
            xml_base = os.path.splitext(os.path.basename(xmls[0]))[0]
            for f in sorted(os.scandir(sub), key=lambda e: e.name):
                if f.name.endswith(".diag") and \
                        f.name[:-len(".diag")] != xml_base:
                    _delete(f.path, apply)
            if objects:
                refs = set(_xml_referenced_geometry(xmls[0]))
                exts = (".city", ".ter", ".veg", ".flp", ".object")
                for f in sorted(os.scandir(sub), key=lambda e: e.name):
                    if f.is_file() and f.name.endswith(exts) \
                            and f.name not in refs:
                        _delete(f.path, apply)
        if p2m:
            subdirs = sorted(f.path for f in os.scandir(sub) if f.is_dir())
            if subdirs:
                study = subdirs[-1]
                for f in sorted(os.scandir(study), key=lambda e: e.name):
                    if f.is_file() and ".paths." not in f.name \
                            and ".pl." not in f.name:
                        _delete(f.path, apply)


# ---------------------------------------------------------------------------
# rename-param-key: bulk-edit a key in every local scenario's params.json
# ---------------------------------------------------------------------------

def rename_param_key(root: str = None, old: str = "txrx",
                     new: str = "txrx_sets", apply: bool = False,
                     skip=()) -> int:
    """Replace the ``old`` top-level key with ``new`` in every
    ``params.json`` under the scenarios folder (format migration; the
    reference applied exactly txrx -> txrx_sets). Returns files hit."""
    if root is None:
        from ..config import config
        root = config.get("scenarios_folder")
    hits = 0
    for path in sorted(glob.glob(os.path.join(root, "*", "params.json"))):
        scen = os.path.basename(os.path.dirname(path))
        if scen in skip:
            continue
        with open(path) as f:
            params = json.load(f)
        if old not in params:
            continue
        _act(apply, f"{path}: rename key {old!r} -> {new!r}")
        if apply:
            params[new] = params.pop(old)
            with open(path, "w") as f:
                json.dump(params, f, indent=2)
        hits += 1
    return hits


# ---------------------------------------------------------------------------
# zoom-image: center-zoom diagnostic renders (PIL-gated)
# ---------------------------------------------------------------------------

def zoom_image(input_path: str, output_path: str,
               zoom: float = 1.5, size=(1920, 1080)) -> None:
    """Center-zoom a scene render: resize to ``size``, enlarge by
    ``zoom``, crop back to ``size`` around the center."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "zoom-image needs Pillow (PIL); not installed here") from e
    img = Image.open(input_path)
    if img.size != size:
        img = img.resize(size, Image.Resampling.LANCZOS)
    w, h = img.size
    big = img.resize((int(w * zoom), int(h * zoom)),
                     Image.Resampling.LANCZOS)
    left = (big.size[0] - w) // 2
    top = (big.size[1] - h) // 2
    big.crop((left, top, left + w, top + h)).save(output_path, quality=95)
    print(f"wrote {output_path}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deepmimo-tpu-torch-insite-ops",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("clean-city")
    p.add_argument("csv")
    p.add_argument("base")
    p.add_argument("--suffix", default="")
    p.add_argument("--apply", action="store_true")

    p = sub.add_parser("clean-sources")
    p.add_argument("base")
    p.add_argument("--extra-deepmimo", action="store_true")
    p.add_argument("--p2m", action="store_true")
    p.add_argument("--objects", action="store_true")
    p.add_argument("--apply", action="store_true")

    p = sub.add_parser("move-insite-out")
    p.add_argument("folders", nargs="+")
    p.add_argument("--apply", action="store_true")

    p = sub.add_parser("rename-param-key")
    p.add_argument("--root", default=None)
    p.add_argument("--old", default="txrx")
    p.add_argument("--new", default="txrx_sets")
    p.add_argument("--apply", action="store_true")

    p = sub.add_parser("zoom-image")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--zoom", type=float, default=1.5)

    a = ap.parse_args(argv)
    if a.cmd == "clean-city":
        clean_city_folders(a.csv, a.base, suffix=a.suffix, apply=a.apply)
    elif a.cmd == "clean-sources":
        clean_source_files(a.base, apply=a.apply,
                           extra_deepmimo=a.extra_deepmimo,
                           p2m=a.p2m, objects=a.objects)
    elif a.cmd == "move-insite-out":
        for folder in a.folders:
            move_insite_out(folder, apply=a.apply)
    elif a.cmd == "rename-param-key":
        n = rename_param_key(a.root, a.old, a.new, apply=a.apply)
        print(f"{n} params.json file(s) matched")
    elif a.cmd == "zoom-image":
        zoom_image(a.input, a.output, zoom=a.zoom)
    if a.cmd != "zoom-image" and not getattr(a, "apply", True):
        print("dry run — re-run with --apply to execute")
    return 0


if __name__ == "__main__":
    sys.exit(main())
