"""The benchmark of ``saragan_tpu_torch`` on one NVIDIA H100.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells; see ``portbench/run.py``.
"""

import os
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``; else now)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
