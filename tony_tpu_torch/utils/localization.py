"""Per-role resource localization.

Mirrors the reference's LocalizableResource (tony-core/.../LocalizableResource.java):
resource strings ``path[#alias][::archive]`` are staged into the job dir by the
client and materialized into each task's working directory by the executor —
``::archive`` entries are unzipped (the reference's venv/src-zip handling,
Utils.extractResources, util/Utils.java:758-771).
"""

from __future__ import annotations

import shutil
import zipfile
from dataclasses import dataclass
from pathlib import Path

ARCHIVE_SUFFIX = "::archive"


@dataclass(frozen=True)
class ResourceSpec:
    path: str
    alias: str
    archive: bool

    @classmethod
    def parse(cls, raw: str) -> "ResourceSpec":
        raw = raw.strip()
        archive = raw.endswith(ARCHIVE_SUFFIX)
        if archive:
            raw = raw[: -len(ARCHIVE_SUFFIX)]
        path, _, alias = raw.partition("#")
        if not path:
            raise ValueError(f"empty resource path in {raw!r}")
        return cls(path=path, alias=alias or Path(path).name, archive=archive)


def parse_resources(raws: list[str]) -> list[ResourceSpec]:
    return [ResourceSpec.parse(r) for r in raws if r.strip()]


def stage_resources(specs: list[ResourceSpec], staging_dir: str | Path) -> list[ResourceSpec]:
    """Client side: copy resources into <staging>/resources, return specs
    rewritten to the staged locations."""
    dest_root = Path(staging_dir) / "resources"
    dest_root.mkdir(parents=True, exist_ok=True)
    staged = []
    for spec in specs:
        src = Path(spec.path)
        if not src.exists():
            raise FileNotFoundError(f"resource not found: {spec.path}")
        dest = dest_root / src.name
        if src.is_dir():
            if not dest.exists():
                shutil.copytree(src, dest)
        else:
            shutil.copy2(src, dest)
        staged.append(ResourceSpec(path=str(dest), alias=spec.alias, archive=spec.archive))
    return staged


def localize_resources(specs: list[ResourceSpec], work_dir: str | Path) -> list[Path]:
    """Executor side: materialize staged resources under work_dir by alias,
    expanding ``::archive`` zips."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    out = []
    for spec in specs:
        src = Path(spec.path)
        target = work / spec.alias
        if spec.archive:
            target.mkdir(parents=True, exist_ok=True)
            with zipfile.ZipFile(src) as zf:
                zf.extractall(target)
        elif src.is_dir():
            if not target.exists():
                shutil.copytree(src, target)
        else:
            if not target.exists():
                shutil.copy2(src, target)
        out.append(target)
    return out


def serialize(specs: list[ResourceSpec]) -> str:
    return ",".join(
        s.path + (f"#{s.alias}" if s.alias != Path(s.path).name else "")
        + (ARCHIVE_SUFFIX if s.archive else "")
        for s in specs
    )
