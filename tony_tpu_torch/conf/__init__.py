"""Layered configuration system (the port's own copy of the JAX package's
conf/: the same key table and layering, so one job file runs under
either package's client).

Mirrors the reference's Hadoop-Configuration stack (TonyClient.java:666-700):
defaults -> user config file(s) -> -conf k=v CLI overrides -> site config from
$TONY_CONF_DIR/tony-site.json. The fully-resolved config is frozen to
``tony-final.json`` in the job dir and localized to every task (reference
freezes tony-final.xml, Constants.java:148), so driver/executors/user code all
see one immutable snapshot.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable, Mapping

from . import keys

_DEFAULTS_PATH = Path(__file__).parent / "defaults.json"

SITE_CONF_ENV = "TONY_CONF_DIR"
SITE_CONF_NAME = "tony-site.json"
FINAL_CONF_NAME = "tony-final.json"


def load_defaults() -> dict[str, Any]:
    with open(_DEFAULTS_PATH) as f:
        return json.load(f)


def _coerce(value: str) -> Any:
    """Coerce a CLI string override to bool/int/float when unambiguous."""
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


@dataclass
class RoleSpec:
    """Parsed per-role request — reference models/JobContainerRequest.java."""

    name: str
    instances: int
    memory_mb: int = 2048
    vcores: int = 1
    chips: int = 0
    command: str = ""
    resources: list[str] = field(default_factory=list)
    node_label: str = ""
    depends_on: list[str] = field(default_factory=list)
    max_instances: int = -1
    max_restarts: int = 0
    env: dict[str, str] = field(default_factory=dict)
    priority: int = 0  # unique per role, like reference YARN priorities
    # per-role runtime override ("" = the app-level framework): a
    # multi-tenant job mixes serving replicas with training workers in
    # one session (docs/autoscaling.md)
    framework: str = ""
    # arbiter tier: interactive roles preempt batch roles' capacity
    # under pool pressure (the JAX package's autoscale.py ResourceArbiter;
    # the port refuses the arbiter at the driver's prepare)
    priority_class: str = "interactive"
    # max pool slots this role may hold concurrently (-1 = instances)
    quota: int = -1


class TonyConf:
    """Immutable-ish layered config with role discovery and validation."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        self._data: dict[str, Any] = dict(load_defaults())
        if data:
            self._data.update(data)

    # ------------------------------------------------------------- layering
    @classmethod
    def resolve(
        cls,
        conf_files: Iterable[str | os.PathLike] = (),
        overrides: Iterable[str] = (),
        include_site: bool = True,
    ) -> "TonyConf":
        """defaults -> files (in order) -> k=v overrides -> site conf."""
        conf = cls()
        for path in conf_files:
            conf.update_from_file(path)
        for kv in overrides:
            if "=" not in kv:
                raise ValueError(f"override must be key=value, got: {kv!r}")
            k, v = kv.split("=", 1)
            conf._data[k.strip()] = _coerce(v.strip())
        if include_site:
            site_dir = os.environ.get(SITE_CONF_ENV)
            if site_dir:
                site = Path(site_dir) / SITE_CONF_NAME
                if site.exists():
                    conf.update_from_file(site)
        return conf

    def update_from_file(self, path: str | os.PathLike) -> None:
        with open(path) as f:
            self._data.update(json.load(f))

    # --------------------------------------------------------------- access
    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._data.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._data.get(key, default)
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    def get_list(self, key: str, default: str = "") -> list[str]:
        raw = self._data.get(key, default)
        if isinstance(raw, (list, tuple)):
            # native JSON lists pass through verbatim — stringifying them
            # would comma-split "['a', 'b']" into quote-riddled garbage
            return [str(s).strip() for s in raw if str(s).strip()]
        raw = str(raw or "")
        return [s.strip() for s in re.split(r"[,\s]+", raw) if s.strip()]

    def set(self, key: str, value: Any) -> None:
        self._data[key] = value

    def as_dict(self) -> dict[str, Any]:
        return dict(self._data)

    # ---------------------------------------------------------------- roles
    def roles(self) -> list[str]:
        return keys.discover_roles(self._data)

    def role_specs(self) -> list[RoleSpec]:
        """Parse all roles into RoleSpecs with unique priorities.

        Mirrors Utils.parseContainerRequests (util/Utils.java:371-418):
        priorities are assigned uniquely per role so allocated capacity can be
        matched back to the role that asked for it.
        """
        specs = []
        for prio, role in enumerate(self.roles()):
            get = lambda t, d=None: self._data.get(keys.role_key(role, t), d)
            env_raw = get("env", "") or ""
            env = {}
            for kv in re.split(r"[,;]\s*", str(env_raw)):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    env[k.strip()] = v.strip()
            specs.append(
                RoleSpec(
                    name=role,
                    instances=int(get("instances", 0)),
                    memory_mb=int(get("memory-mb", 2048)),
                    vcores=int(get("vcores", 1)),
                    chips=int(get("chips", 0)),
                    command=str(get("command", "") or ""),
                    resources=[s for s in str(get("resources", "") or "").split(",") if s],
                    node_label=str(get("node-label", "") or ""),
                    depends_on=[
                        s.strip()
                        for s in str(get("depends-on", "") or "").split(",")
                        if s.strip()
                    ],
                    max_instances=int(get("max-instances", -1)),
                    max_restarts=int(get("max-restarts", 0)),
                    env=env,
                    priority=prio,
                    framework=str(get("framework", "") or ""),
                    priority_class=str(
                        get("priority-class", "") or "interactive").lower(),
                    quota=int(get("quota", -1)),
                )
            )
        return specs

    def untracked_roles(self) -> set[str]:
        return set(self.get_list(keys.APPLICATION_UNTRACKED_JOBTYPES))

    # ----------------------------------------------------------- validation
    def validate(self) -> None:
        """Instance/resource caps — reference TonyClient.java:796-866."""
        specs = self.role_specs()
        if not specs:
            raise ValueError("no roles configured (need at least one tony.<role>.instances)")
        total_inst = sum(s.instances for s in specs)
        if total_inst <= 0:
            raise ValueError("total instances must be > 0")
        max_inst = self.get_int(keys.TASK_MAX_TOTAL_INSTANCES, -1)
        if 0 <= max_inst < total_inst:
            raise ValueError(
                f"total instances {total_inst} exceeds {keys.TASK_MAX_TOTAL_INSTANCES}={max_inst}"
            )
        max_mem = self.get_int(keys.TASK_MAX_TOTAL_MEMORY_MB, -1)
        total_mem = sum(s.memory_mb * s.instances for s in specs)
        if 0 <= max_mem < total_mem:
            raise ValueError(
                f"total memory {total_mem}mb exceeds {keys.TASK_MAX_TOTAL_MEMORY_MB}={max_mem}"
            )
        max_chips = self.get_int(keys.TASK_MAX_TOTAL_CHIPS, -1)
        total_chips = sum(s.chips * s.instances for s in specs)
        if 0 <= max_chips < total_chips:
            raise ValueError(
                f"total chips {total_chips} exceeds {keys.TASK_MAX_TOTAL_CHIPS}={max_chips}"
            )
        for s in specs:
            if 0 <= s.max_instances < s.instances:
                raise ValueError(
                    f"role {s.name}: instances {s.instances} exceeds max-instances {s.max_instances}"
                )
        for s in specs:
            if s.priority_class not in ("interactive", "batch"):
                raise ValueError(
                    f"role {s.name}: priority-class must be 'interactive' "
                    f"or 'batch', got {s.priority_class!r}")
        if self.get_bool(keys.AUTOSCALE_ENABLED, False):
            role = str(self.get(keys.AUTOSCALE_ROLE, "") or "")
            if not role and len(specs) != 1:
                raise ValueError(
                    f"{keys.AUTOSCALE_ROLE} is required when the job has "
                    f"more than one role")
            if role and role not in {s.name for s in specs}:
                raise ValueError(
                    f"{keys.AUTOSCALE_ROLE}={role!r} names no configured "
                    "role")
        mode = str(self.get(keys.APPLICATION_DISTRIBUTED_MODE, "GANG")).upper()
        if mode not in ("GANG", "FCFS"):
            raise ValueError(f"distributed-mode must be GANG or FCFS, got {mode}")
        if self.get_bool(keys.DOCKER_ENABLED, False):
            # fail at submit, not per-executor at runtime
            for s in specs:
                if not (self.get(keys.docker_image_key(s.name))
                        or self.get(keys.DOCKER_IMAGE)):
                    raise ValueError(
                        f"{keys.DOCKER_ENABLED} is set but no image for role "
                        f"{s.name!r}: set {keys.DOCKER_IMAGE} or "
                        f"{keys.docker_image_key(s.name)}"
                    )

    # ------------------------------------------------------------- freezing
    def write_final(self, job_dir: str | os.PathLike) -> Path:
        """Freeze the resolved config — reference tony-final.xml write
        (TonyClient.java:232-315, ApplicationMaster.java:558-568)."""
        path = Path(job_dir) / FINAL_CONF_NAME
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._data, f, indent=2, sort_keys=True)
        return path

    @classmethod
    def from_final(cls, job_dir: str | os.PathLike) -> "TonyConf":
        with open(Path(job_dir) / FINAL_CONF_NAME) as f:
            return cls(json.load(f))
