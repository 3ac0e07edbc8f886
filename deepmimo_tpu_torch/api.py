"""Scenario database client: upload / download / search.

HTTP client for the DeepMIMO scenario database: zip + hash +
presigned-URL upload, token/redirect download, and JSON query search.
Copied from ``deepmimo_tpu/api.py``; a failed request raises ``ApiError``.
``download`` extracts a scenario so that its ``params.json`` lands in
``<output_dir>/<name>`` and returns that folder, the one ``load(name)``
reads.
"""

from __future__ import annotations

import hashlib
import json
import os
import urllib.error
import urllib.request
import zipfile
from typing import Any, Dict, List, Optional

from .config import config
from .utils import (check_scen_name, get_scenario_folder, get_scenarios_dir,
                    zip as zip_folder)

HEADERS = {
    "User-Agent": "DeepMIMO-TPU/0.1",
    "Accept": "*/*",
}


class ApiError(RuntimeError):
    """Raised when a database operation fails (network, auth, validation)."""


def _endpoint() -> str:
    return config.get("api_endpoint").rstrip("/")


def _request(url: str, data: Optional[bytes] = None,
             headers: Optional[Dict[str, str]] = None, method: str = "GET",
             timeout: float = 30.0) -> bytes:
    req = urllib.request.Request(url, data=data,
                                 headers={**HEADERS, **(headers or {})},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except (urllib.error.URLError, urllib.error.HTTPError, OSError) as e:
        raise ApiError(f"Request to {url} failed: {e}") from e


def _sha256_of_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# ============================================================================
# Website submission metadata
# ============================================================================

def generate_key_components(summary_str: str) -> Dict[str, Any]:
    """Parse a scenario summary into the website's key-component sections.

    The database indexes submissions by these sections: the summary's
    ``[Section]``
    headers become section names; within a section, a bare line starts a
    subsection and ``- `` lines under it become list items. The returned
    structure is ``{"sections": [{"name", "description"(html)}]}``.
    """
    sections: List[Dict[str, str]] = []
    name: Optional[str] = None
    body: List[str] = []

    def flush():
        if name is not None:
            sections.append({"name": name,
                             "description": _section_html(body)})

    for raw in summary_str.splitlines():
        line = raw.strip()
        if not line or set(line) == {"="}:
            continue
        if line[0] == "[" and line[-1] == "]":
            flush()
            name, body = line[1:-1], []
        elif name is not None:
            body.append(line)
    flush()
    return {"sections": sections}


def _section_html(lines: List[str]) -> str:
    """Render one section's lines to the HTML fragment the website stores."""
    groups: List[List[str]] = []
    for line in lines:
        if line.startswith("-"):
            if not groups:
                groups.append([])
            groups[-1].append(line)
        else:
            groups.append([line])

    parts: List[str] = []
    for grp in groups:
        header, items = grp[0], grp[1:]
        if not items:
            parts.append(f"<p>{header}</p>")
            continue
        parts.append(f"<h4>{header}</h4>")
        parts.append("<ul>")
        parts.extend(f"<li>{it[2:]}</li>" for it in items)
        parts.append("</ul>")
    inner = "".join(parts)
    return f'<div class="section-content">{inner}</div>'


# ============================================================================
# Upload
# ============================================================================

def upload(scenario_name: str, key: str,
           include_images: bool = True) -> Dict[str, Any]:
    """Upload a scenario: zip it, push to storage, register a submission.

    Args:
        scenario_name: name of a locally available scenario.
        key: user API key for the database.
        include_images: also render and upload summary images.
    """
    check_scen_name(scenario_name)
    folder = get_scenario_folder(scenario_name)
    if not os.path.isdir(folder):
        raise ApiError(f"Scenario '{scenario_name}' not found at {folder}")

    zip_path = zip_folder(folder)
    sha = _sha256_of_file(zip_path)

    # 1) ask the server for a presigned storage URL
    presign = json.loads(_request(
        f"{_endpoint()}/api/presign?filename={os.path.basename(zip_path)}",
        headers={"Authorization": f"Bearer {key}"}))
    # 2) PUT the archive
    with open(zip_path, "rb") as f:
        _request(presign["url"], data=f.read(),
                 headers={"Content-Type": "application/zip",
                          "X-Content-Sha256": sha}, method="PUT",
                 timeout=600.0)
    # 3) register the submission with its params summary + the parsed
    #    key components the database indexes for search
    from .summary import summary as _summary
    summary_str = _summary(scenario_name, print_summary=False)
    body = json.dumps({
        "scenario": scenario_name,
        "sha256": sha,
        "summary": summary_str,
        "key_components": generate_key_components(summary_str),
    }).encode()
    submission = json.loads(_request(
        f"{_endpoint()}/api/submissions", data=body,
        headers={"Authorization": f"Bearer {key}",
                 "Content-Type": "application/json"}, method="POST"))
    if include_images:
        try:
            upload_images(scenario_name, key)
        except ApiError as e:
            print(f"Image upload skipped: {e}")
    return submission


def upload_rt_source(scenario_name: str, rt_zip_path: str, key: str) -> None:
    """Upload the raw ray-tracer source archive for a scenario (<= 5 GB)."""
    size = os.path.getsize(rt_zip_path)
    if size > 5 * (1 << 30):
        raise ApiError("RT source archives are limited to 5 GB")
    presign = json.loads(_request(
        f"{_endpoint()}/api/presign_rt?scenario={scenario_name}",
        headers={"Authorization": f"Bearer {key}"}))
    with open(rt_zip_path, "rb") as f:
        _request(presign["url"], data=f.read(),
                 headers={"Content-Type": "application/zip"}, method="PUT",
                 timeout=3600.0)


def upload_images(scenario_name: str, key: str,
                  img_paths: Optional[List[str]] = None) -> None:
    """Upload scenario preview images (rendering them if not provided)."""
    if img_paths is None:
        from .summary import plot_summary
        img_paths = plot_summary(scenario_name, save_imgs=True,
                                 show_plots=False)
    for path in img_paths or []:
        with open(path, "rb") as f:
            _request(f"{_endpoint()}/api/images?scenario={scenario_name}"
                     f"&name={os.path.basename(path)}",
                     data=f.read(), headers={
                         "Authorization": f"Bearer {key}",
                         "Content-Type": "image/png"}, method="POST")


# ============================================================================
# Download
# ============================================================================

def download(scenario_name: str,
             output_dir: Optional[str] = None) -> str:
    """Download and extract a scenario; returns the folder that holds its
    ``params.json``, ``<output_dir>/<scenario_name>`` (by default under
    the scenarios folder, where ``load(scenario_name)`` looks)."""
    check_scen_name(scenario_name)
    out_dir = output_dir or get_scenarios_dir()
    os.makedirs(out_dir, exist_ok=True)

    token = json.loads(_request(
        f"{_endpoint()}/api/download?scenario={scenario_name}"))
    url = token.get("url")
    if not url:
        raise ApiError(f"Server returned no download URL for "
                       f"'{scenario_name}'")
    zip_path = os.path.join(out_dir, f"{scenario_name}.zip")
    data = _request(url, timeout=3600.0)
    with open(zip_path, "wb") as f:
        f.write(data)
    folder = os.path.join(out_dir, scenario_name)
    try:
        _extract_scenario(zip_path, folder)
    finally:
        os.remove(zip_path)
    return folder


def _extract_scenario(zip_path: str, folder: str) -> None:
    """Extract a scenario archive into ``folder``. An archive whose entries
    all sit under one top folder (as ``zip`` writes a scenario folder) has
    that folder stripped, so the scenario's files land in ``folder`` and
    not one level below it."""
    with zipfile.ZipFile(zip_path) as zf:
        infos = zf.infolist()
        tops = {info.filename.split("/", 1)[0] for info in infos}
        strip = len(tops) == 1 and all("/" in info.filename
                                       for info in infos)
        for info in infos:
            if strip:
                info.filename = info.filename.split("/", 1)[1]
                if not info.filename:
                    continue
            zf.extract(info, folder)


# ============================================================================
# Search
# ============================================================================

def search(query: Dict[str, Any]) -> List[str]:
    """Search the scenario database; returns matching scenario names.

    Query keys mirror the website filters, e.g.::

        dm.search({'environment': 'outdoor', 'min_users': 10000,
                   'frequency': 3.5e9})
    """
    body = json.dumps(query).encode()
    result = json.loads(_request(
        f"{_endpoint()}/api/search", data=body,
        headers={"Content-Type": "application/json"}, method="POST"))
    return result.get("scenarios", [])
