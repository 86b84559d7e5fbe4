"""The card's clocks, power and temperature sampled beside a window.

``nvidia-smi`` runs as a child process that prints a line every
``period_ms``; ``stop`` ends it, waits for it, and reads the samples. The
samples let a run whose card ran slower (a lower power limit, a clock
drop, heat) be told from a slower program.
"""

from __future__ import annotations

import shutil
import statistics
import subprocess
from typing import Optional

FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "power.limit",
          "temperature.gpu")


class PowerLog:
    def __init__(self, path: str, period_ms: int = 500):
        self.path = path
        self.proc: Optional[subprocess.Popen] = None
        self._out = None
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return
        self._out = open(path, "w")
        self.proc = subprocess.Popen(
            [exe, f"--query-gpu={','.join(FIELDS)}",
             "--format=csv,noheader,nounits", "-i", "0",
             f"-lms={period_ms}"],
            stdout=self._out, stderr=subprocess.DEVNULL)

    def stop(self) -> dict:
        """End the sampler and summarise its samples: each reported
        field's least, median and largest value, and the number of
        samples."""
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._out.close()
        cols = {name: [] for name in FIELDS}
        samples = 0
        with open(self.path) as f:
            for line in f:
                parts = [p.strip() for p in line.split(",")]
                if len(parts) != len(FIELDS):
                    continue
                samples += 1
                for name, part in zip(FIELDS, parts):
                    try:  # a field the card does not report reads "[N/A]"
                        cols[name].append(float(part))
                    except ValueError:
                        pass
        out = {"samples": samples}
        for name, col in cols.items():
            if col:
                out[name] = [min(col), statistics.median(col), max(col)]
        return out
