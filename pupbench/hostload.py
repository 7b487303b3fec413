"""What this process did on the host while a phase of a run lasted: its
CPU seconds over all threads, the CPUs that makes on average, and its
threads at the end. A phase that takes longer with the same CPU seconds
had less of the host; one that takes more CPU seconds did more work or
waited in it. Of those, the kernel's seconds say how much of it was the
kernel's, such as mapping fresh memory. Printed beside the result, never
a metric. (The card's machine is a sandbox whose ``/proc/stat`` and load
average read nothing, and that counts no context switches or page
faults.)"""

from __future__ import annotations

import os
import resource
import time


def threads():
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


class Snapshot:
    def __init__(self):
        self.t = time.perf_counter()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu, self.sys = ru.ru_utime + ru.ru_stime, ru.ru_stime
        self.main_cpu = time.thread_time()


def between(a, b):
    wall = b.t - a.t
    return {
        "wall_s": wall,
        "cpus": os.cpu_count(),
        "process_cpu_s": b.cpu - a.cpu,
        "process_cpus": (b.cpu - a.cpu) / wall if wall > 0 else None,
        "main_thread_cpu_s": b.main_cpu - a.main_cpu,
        "process_threads": threads(),
        "process_sys_s": b.sys - a.sys,
    }
