"""Path-checked extraction of dataset archives.

Counterpart of `safe_extract_tar` and `safe_extract_zip` in
hyperseg_tpu/utils/download.py:18-60. The JAX module's `download_url` has no
counterpart: this package fetches nothing, and a dataset whose files are
missing raises.
"""

from __future__ import annotations

import os


def _is_within(base: str, target: str) -> bool:
    base = os.path.abspath(base)
    return os.path.commonpath([base, os.path.abspath(target)]) == base


def safe_extract_tar(tar_path: str, dest: str) -> None:
    """extractall with path-traversal protection: a member like `../../x`
    must not write outside `dest`. Uses the stdlib "data" filter where
    available."""
    import tarfile
    with tarfile.open(tar_path) as tar:
        try:
            tar.extractall(path=dest, filter="data")
        except TypeError:  # Python < 3.12 security backport absent
            for m in tar.getmembers():
                if not _is_within(dest, os.path.join(dest, m.name)):
                    raise RuntimeError(
                        f"unsafe tar member path: {m.name!r} in {tar_path}")
                # name checks alone don't stop writing through a symlink
                # member ('link' -> /elsewhere, then 'link/payload'); the
                # datasets these archives carry contain no links, so reject
                # them outright like the 'data' filter would
                if m.issym() or m.islnk():
                    raise RuntimeError(
                        f"link member not allowed: {m.name!r} in {tar_path}")
            tar.extractall(path=dest)


def safe_extract_zip(zip_path, dest: str) -> None:
    """ZipFile.extractall with explicit member-path validation (zipfile
    already sanitizes most traversal forms, but fail loud, not quietly)."""
    from zipfile import ZipFile
    owned = isinstance(zip_path, (str, os.PathLike))
    z = ZipFile(zip_path) if owned else zip_path
    try:
        for name in z.namelist():
            if name.startswith("/") or ".." in name.split("/"):
                raise RuntimeError(f"unsafe zip member path: {name!r}")
        z.extractall(dest)
    finally:
        if owned:  # never close a caller-supplied handle
            z.close()
