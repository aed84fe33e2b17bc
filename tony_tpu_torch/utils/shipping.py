"""Job-archive shipping: distribute the staged job to remote executor hosts.

The reference uploads the src zip, python venv, and frozen config to HDFS
staging (TonyClient.java:232-315) and every container downloads + unpacks
them before the task starts (Utils.extractResources, util/Utils.java:758-771).
This is the port's own copy of the JAX package's transport-agnostic
equivalent for fleets where
there is no HDFS: the client tars the staged job dir (frozen config, src/,
resources/), optionally uploads it with a user-supplied command (gsutil on
GCP, scp on bare SSH clusters), and each executor fetches + unpacks the
archive into a host-local directory that then serves as its job dir.

Supported archive URIs on the fetch side:
  /abs/path or file://...   shared or local filesystem (cp)
  scp://host:/path          scp -o BatchMode=yes
  gs://bucket/key           gsutil cp
  http(s)://...             urllib
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tarfile
import tempfile
import urllib.request
from pathlib import Path

log = logging.getLogger(__name__)

ARCHIVE_NAME = "job_archive.tar.gz"
# written next to the unpacked content recording the digest verified at
# unpack time, so the idempotent-reuse path can enforce it too
_DIGEST_MARKER = ".archive_sha256"
# client-staged content worth shipping; logs/workdir/events are runtime output
_SHIP_EXCLUDE = {"logs", "workdir", "driver.log", "driver_info.json",
                 ARCHIVE_NAME, "events"}


def build_job_archive(job_dir: str | Path) -> Path:
    """Tar the staged inputs of job_dir (frozen conf, src/, resources/) into
    <job_dir>/job_archive.tar.gz and return its path."""
    job_dir = Path(job_dir)
    out = job_dir / ARCHIVE_NAME
    with tarfile.open(out, "w:gz") as tf:
        for entry in sorted(job_dir.iterdir()):
            if entry.name in _SHIP_EXCLUDE:
                continue
            tf.add(entry, arcname=entry.name)
    return out


def sha256_file(path: str | Path) -> str:
    """Hex sha256 of a file, streamed."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def upload_archive(archive: Path, uri: str, upload_cmd: str) -> None:
    """Run the user-supplied upload command ({archive} and {uri} templates) —
    the HDFS-upload seam without baking in one cloud's CLI."""
    # token replace, not str.format: the command is arbitrary shell where
    # literal braces (${VAR}, awk '{...}') are ordinary syntax
    cmd = upload_cmd.replace("{archive}", str(archive)).replace("{uri}", uri)
    log.info("uploading job archive: %s", cmd)
    subprocess.run(cmd, shell=True, check=True, timeout=600)


def fetch_archive(uri: str, dest: Path) -> Path:
    """Fetch the archive at `uri` to local file `dest` (see module docstring
    for supported schemes)."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    if uri.startswith("scp://"):
        # scp://host:/path or scp://host:path
        rest = uri[len("scp://"):]
        host, _, path = rest.partition(":")
        if not host or not path:
            raise ValueError(f"bad scp uri (need scp://host:/path): {uri}")
        subprocess.run(
            ["scp", "-o", "BatchMode=yes", f"{host}:{path}", str(dest)],
            check=True, timeout=600,
        )
    elif uri.startswith("gs://"):
        subprocess.run(
            ["gsutil", "cp", uri, str(dest)], check=True, timeout=600
        )
    elif uri.startswith(("http://", "https://")):
        with urllib.request.urlopen(uri, timeout=600) as r, open(dest, "wb") as f:
            shutil.copyfileobj(r, f)
    else:
        shutil.copyfile(uri, dest)
    return dest


def localize_job(uri: str, app_id: str, base_dir: str | None = None,
                 sha256: str | None = None) -> str:
    """Executor side: fetch + unpack the job archive into a host-local
    directory and return it (the executor's job dir from then on) — reference
    Utils.extractResources (util/Utils.java:758-771).

    When `sha256` is given (frozen at submit time), the fetched bytes are
    verified BEFORE unpack and a mismatch raises — a tampered or truncated
    archive must never execute (the integrity role of the reference's
    kerberized HDFS staging, TonyClient.java:981-1030).

    Idempotent per (base, app_id): a directory that already holds the frozen
    config is reused, so multiple executors on one host fetch once."""
    from ..conf import FINAL_CONF_NAME

    base = Path(base_dir or os.environ.get("TONY_LOCAL_DIR", "")
                or Path(tempfile.gettempdir()) / "tony-localized")
    target = base / app_id
    final = target / FINAL_CONF_NAME
    marker = target / _DIGEST_MARKER
    if final.exists():
        # the reuse path must uphold the same integrity guarantee as a fresh
        # fetch: the unpacker records what it verified in a marker file, and
        # a digest-expecting caller refuses a dir localized without (or with
        # a different) verification rather than executing unchecked content
        if sha256:
            recorded = marker.read_text().strip() if marker.exists() else ""
            if recorded != sha256.lower():
                raise ValueError(
                    f"localized job dir {target} was unpacked from an archive "
                    f"with sha256 {recorded or '<unverified>'}, but this task "
                    f"expects {sha256} — refusing to reuse it"
                )
        log.info("job already localized at %s", target)
        return str(target)
    base.mkdir(parents=True, exist_ok=True)
    # tmp lives inside base so the final os.replace is a same-fs rename
    tmp = Path(tempfile.mkdtemp(prefix=f"{app_id}-fetch-", dir=str(base)))
    try:
        archive = fetch_archive(uri, tmp / ARCHIVE_NAME)
        if sha256:
            got = sha256_file(archive)
            if got != sha256.lower():
                raise ValueError(
                    f"job archive integrity check failed for {uri}: "
                    f"expected sha256 {sha256}, fetched {got} — refusing to "
                    f"unpack (tampered or truncated archive)"
                )
        unpack = tmp / "unpacked"
        unpack.mkdir()
        with tarfile.open(archive) as tf:
            try:
                tf.extractall(unpack, filter="data")
            except TypeError:  # Python < 3.10.12: no `filter` kwarg
                tf.extractall(unpack)
        if not (unpack / FINAL_CONF_NAME).exists():
            raise FileNotFoundError(
                f"archive at {uri} has no {FINAL_CONF_NAME} — not a job archive"
            )
        if sha256:
            (unpack / _DIGEST_MARKER).write_text(sha256.lower() + "\n")
        target.parent.mkdir(parents=True, exist_ok=True)
        try:
            os.replace(unpack, target)  # atomic: concurrent executors race safely
        except OSError:
            if not final.exists():  # lost the race AND nobody else won it
                raise
        log.info("localized job archive %s -> %s", uri, target)
        return str(target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
