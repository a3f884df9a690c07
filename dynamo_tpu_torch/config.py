"""Runtime configuration of the port's launcher (a copy of the JAX
package's config.py, cut to the fields the local launcher reads: the
HTTP address and the engine defaults).

Layers, later ones winning: dataclass defaults <- TOML file
(``DYNTPU_CONFIG`` or ./dynamo_tpu.toml, a ``[runtime]`` table or flat
keys) <- ``DYNTPU_*`` environment variables.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Any, Optional

log = logging.getLogger(__name__)

ENV_PREFIX = "DYNTPU_"


@dataclass
class RuntimeConfig:
    """Process-wide defaults of ``launch.run``'s flags."""

    http_host: str = "0.0.0.0"
    http_port: int = 8080
    page_size: int = 64
    num_pages: int = 512
    max_decode_slots: int = 8
    cache_dtype: str = "bfloat16"
    kv_quant: str = "none"
    round_pipeline: bool = True
    host_offload_pages: int = 0
    disk_offload_pages: int = 0
    disk_offload_path: Optional[str] = None
    scrub_on_start: bool = False


def _coerce(value: str, target_type) -> Any:
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def load_config(
    path: Optional[str] = None, env: Optional[dict[str, str]] = None
) -> RuntimeConfig:
    """defaults <- TOML file <- DYNTPU_* env (later layers win). The cwd
    fallback file (./dynamo_tpu.toml) applies only under the real process
    environment — an explicit ``env`` asks for isolation."""
    from_process_env = env is None
    env = os.environ if env is None else env
    values: dict[str, Any] = {}

    path = path or env.get(ENV_PREFIX + "CONFIG")
    if path is None and from_process_env and os.path.exists("dynamo_tpu.toml"):
        path = "dynamo_tpu.toml"
    if path:
        import tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)
        section = data.get("runtime", data)  # [runtime] table or flat
        for f_ in dataclasses.fields(RuntimeConfig):
            if f_.name in section:
                values[f_.name] = section[f_.name]

    for f_ in dataclasses.fields(RuntimeConfig):
        key = ENV_PREFIX + f_.name.upper()
        if key in env:
            # field types are stringified (future annotations); the
            # default value's concrete type is the coercion target
            try:
                values[f_.name] = _coerce(env[key], type(f_.default))
            except ValueError:
                log.warning("ignoring invalid %s=%r", key, env[key])
    return RuntimeConfig(**values)
