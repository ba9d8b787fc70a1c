"""Infrastructure utilities (reference components: timing.{h,c},
affinity.{h,c}, util.{h,c}, allocate.{h,c} — SURVEY §2 rows 14, 15, 17, 18).

Translations:
  * ``get_timestamp`` — monotonic wall clock (reference timing.c:8-20).
  * ``change_file_ending`` — reference util.c:11-31.
  * ``device_banner`` — the reference prints a rank -> host/pid/affinity map
    at startup (commPrintBanner, comm.c:185-274; affinity.c mask dump). The
    analog here is the device table: id, kind, platform, memory stats.
  * ``device_memory_stats`` — the reference wraps posix_memalign with an
    exit-on-failure allocator (allocate.c:12-36); device allocation is
    XLA's arena, so the useful parity surface is introspection, not
    allocation.
  * ``device_platform`` / ``enable_compile_cache`` — the one place that
    knows which device the process runs on, and where its compile cache
    lives.
"""

from __future__ import annotations

import os
import socket
import time
from typing import List, Optional


def get_timestamp() -> float:
    """Reference getTimeStamp (timing.c:8-14)."""
    return time.monotonic()


def get_timer_resolution() -> float:
    """Reference getTimeResolution (timing.c:16-20)."""
    return time.get_clock_info("monotonic").resolution


def change_file_ending(filename: str, new_ending: str) -> str:
    """Reference changeFileEnding (util.c:11-31): swap the extension."""
    base = filename.rsplit(".", 1)[0]
    if not new_ending.startswith("."):
        new_ending = "." + new_ending
    return base + new_ending


def device_memory_stats(device) -> Optional[dict]:
    try:
        return device.memory_stats()
    except Exception:
        return None


def device_banner() -> str:
    """Device table (reference rank -> host/pid banner, comm.c:240-274)."""
    import jax

    host = socket.gethostname()
    pid = os.getpid()
    lines = [f"Process {pid} on host {host}:"]
    for d in jax.devices():
        stats = device_memory_stats(d)
        mem = ""
        if stats and "bytes_limit" in stats:
            used = stats.get("bytes_in_use", 0) / 1e9
            lim = stats["bytes_limit"] / 1e9
            mem = f"  mem {used:.1f}/{lim:.1f} GB"
        lines.append(
            f"  device {d.id}: {d.device_kind} ({d.platform}){mem}"
        )
    return "\n".join(lines)


# The checkout this package was imported from: the default home of the
# persistent compile cache (a fixed path, because the path is part of
# what the cache's entries are found by).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLATFORMS = ("gpu", "cpu")


def check_platform(platform: str, requested: Optional[str]) -> str:
    """Validate the platform JAX computes on. ``requested`` is the
    ``jax_platforms`` setting (JAX_PLATFORMS). The CPU is accepted only
    when it was asked for: JAX falls back to it silently when it finds
    no GPU, and a run that believes it measured the card must not."""
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}; this program runs on "
            f"{' or '.join(PLATFORMS)}"
        )
    if platform == "cpu" and "cpu" not in (requested or "").split(","):
        raise RuntimeError(
            "JAX found no GPU; set JAX_PLATFORMS=cpu to run on the host "
            "CPU deliberately"
        )
    return platform


def device_platform() -> str:
    """The platform of this process's devices: "gpu" or "cpu" (see
    check_platform)."""
    import jax

    return check_platform(jax.devices()[0].platform,
                          jax.config.jax_platforms)


def compile_cache_dir() -> Optional[str]:
    """Directory of the persistent compile cache for this process:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    on the GPU, and none for CPU runs (XLA:CPU executables carry the host's
    instruction set, and a checkout copied to another machine must not
    load them)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if device_platform() == "cpu":
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Enable JAX's persistent compilation cache (XLA executables
    serialized to disk) so a fresh process reuses them; set-up is
    compile-dominated. Returns the directory, or None when off. With
    ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and no other
    directory is set here."""
    path = compile_cache_dir()
    if path is not None and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
