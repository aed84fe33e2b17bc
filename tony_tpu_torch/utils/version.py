"""Build/version identification injected into the resolved job config.

Mirrors the reference VersionInfo (tony-core/.../util/VersionInfo.java, used
at TonyClient.java:195): version + VCS revision/branch + build user are
stamped into the frozen config so the portal and history files record exactly
which framework build ran the job. The reference bakes these in at compile
time from a generated properties file; here they are resolved lazily from the
installed package metadata and (when running from a checkout) `git`.
"""

from __future__ import annotations

import functools
import os
import subprocess

VERSION = "0.1.0"

# conf keys the client stamps (reference injectVersionInfo -> tony.version.*)
VERSION_KEY = "tony.version"
REVISION_KEY = "tony.version.revision"
BRANCH_KEY = "tony.version.branch"
BUILD_USER_KEY = "tony.version.user"


def _git(*args: str) -> str:
    # only trust git when the framework itself is the checkout — an installed
    # package may sit inside some unrelated repository (a user project's
    # venv), whose SHA must not be stamped as the framework build identity
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo_root = os.path.dirname(pkg_root)
    if not os.path.isdir(os.path.join(repo_root, ".git")):
        return ""
    try:
        out = subprocess.run(
            ["git", *args], cwd=pkg_root,
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


@functools.lru_cache(maxsize=1)
def version_info() -> dict[str, str]:
    return {
        VERSION_KEY: VERSION,
        REVISION_KEY: _git("rev-parse", "--short", "HEAD") or "unknown",
        BRANCH_KEY: _git("rev-parse", "--abbrev-ref", "HEAD") or "unknown",
        BUILD_USER_KEY: os.environ.get("USER", "unknown"),
    }


def inject(conf) -> None:
    """Stamp version keys into a TonyConf before it is frozen as final."""
    for k, v in version_info().items():
        conf.set(k, v)
