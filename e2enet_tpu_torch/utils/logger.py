"""Timestamped run logger with write-retry.

Parity: reference nnUNetTrainer_simple.print_to_log_file
(nnUNetTrainer_simple.py:1106-1138) — timestamped text log per training run,
retried writes (network filesystems), optional stdout echo.

The port's own copy of e2enet_tpu/utils/logger.py, unchanged but for this
note: the port imports nothing of the JAX package.
"""
import os
import time
from datetime import datetime


class RunLogger:
    def __init__(self, output_folder=None, also_print=True):
        self.output_folder = output_folder
        self.also_print = also_print
        self.log_file = None

    def _ensure_file(self):
        if self.log_file is None and self.output_folder is not None:
            os.makedirs(self.output_folder, exist_ok=True)
            ts = datetime.now()
            self.log_file = os.path.join(
                self.output_folder,
                "training_log_%d_%d_%d_%02.0d_%02.0d_%02.0d.txt" %
                (ts.year, ts.month, ts.day, ts.hour, ts.minute, ts.second))
            with open(self.log_file, "w") as f:
                f.write("Starting... \n")

    def log(self, *args, add_timestamp=True, also_print_to_console=None):
        if also_print_to_console is None:
            also_print_to_console = self.also_print
        timestamp = time.time()
        dt_object = datetime.fromtimestamp(timestamp)
        if add_timestamp:
            args = (f"{dt_object}:",) + tuple(args)
        self._ensure_file()
        if self.log_file is not None:
            ok = False
            max_attempts = 5
            ctr = 0
            while not ok and ctr < max_attempts:
                try:
                    with open(self.log_file, "a+") as f:
                        for a in args:
                            f.write(str(a))
                            f.write(" ")
                        f.write("\n")
                    ok = True
                except IOError:
                    time.sleep(0.5)
                    ctr += 1
        if also_print_to_console:
            print(*args)
