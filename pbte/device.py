"""What the program reads from the device it runs on, and where it keeps
its compiled programs.

Size decisions (state dtype, buffer donation, rhs hoisting, ring
eligibility) are fractions of `memory_budget()`, never bytes assumed for a
particular card. The compile cache lives where `JAX_COMPILATION_CACHE_DIR`
says, and otherwise at a fixed path beside the package, so that it is found
again whatever the caller's working directory.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def memory_budget() -> int:
    """Bytes the first JAX device lets this process allocate.

    On an accelerator this is the allocator's `bytes_limit`; on the CPU,
    which keeps no such statistics, it is the host's physical memory. An
    accelerator that reports no limit is an error: no size is assumed."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {dev.device_kind!r} ({dev.platform}) reports no "
            "memory limit; cannot size the solver's memory policy"
        )
    return int(stats["bytes_limit"])


def card() -> str:
    """Name and power limit of each GPU, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` reports
    them. Raises OSError or subprocess.SubprocessError without nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<repo>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`.

    When the environment variable is set JAX already reads it, and only
    the entry-size thresholds are set here. Returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path


def _best_seconds(fn, arg, reps):
    """Fastest of `reps` synced calls of `fn(arg)`, after one warm-up call."""
    import time

    import jax

    jax.block_until_ready(fn(arg))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        best = min(best, time.perf_counter() - t0)
    return best


def matmul_rate(dtype="bfloat16", n=8192, chain=8, reps=3, precision=None):
    """FLOP/s a plain (n, n) @ (n, n) matrix product reaches on the device.

    `chain` dependent products run inside one jit, so dispatch does not
    enter the time. A peak measured in the same run as the kernel it scales,
    never a constant."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    a = jax.random.normal(jax.random.PRNGKey(0), (n, n), jnp.float32)
    a = (a / n ** 0.5).astype(dtype)

    @jax.jit
    def run(x):
        def body(c, _):
            y = jnp.dot(c, x, precision=precision,
                        preferred_element_type=jnp.float32)
            return y.astype(dtype), None

        c, _ = lax.scan(body, x, None, length=chain)
        return c

    return 2.0 * n ** 3 * chain / _best_seconds(run, a, reps)


def copy_bandwidth(mbytes=1024, chain=16, reps=3):
    """Bytes/s a streaming read-plus-write pass over an f32 buffer reaches."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = int(mbytes * 2 ** 20) // 4
    x = jnp.ones((n,), jnp.float32)

    @jax.jit
    def run(x):
        c, _ = lax.scan(lambda c, _: (c * 1.000001, None), x, None,
                        length=chain)
        return c

    return 2.0 * n * 4 * chain / _best_seconds(run, x, reps)
