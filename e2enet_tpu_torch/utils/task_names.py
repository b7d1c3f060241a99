"""Task id <-> task name conversion.

Parity: reference e2enet/utilities/task_name_id_conversion.py:21,64. The
reference resolves names by scanning raw/cropped/preprocessed dirs; we do the
same but with an explicit error message.

The port's own copy of e2enet_tpu/utils/task_names.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
import os

from .. import paths


def convert_id_to_task_name(task_id: int) -> str:
    startswith = "Task%03.0d" % task_id
    candidates = []
    for d in (paths.get_preprocessing_output_dir(), paths.get_raw_data_dir(),
              paths.get_cropped_data_dir(), paths.get_results_dir()):
        if d is not None and os.path.isdir(d):
            for name in os.listdir(d):
                if name.startswith(startswith):
                    candidates.append(name)
    unique = sorted(set(candidates))
    if len(unique) == 0:
        raise RuntimeError(
            f"Could not find a task with id {task_id}. Make sure the "
            f"requested task is downloaded/converted and the paths are set.")
    if len(unique) > 1:
        raise RuntimeError(
            f"More than one task name found for id {task_id}: {unique}")
    return unique[0]


def convert_task_name_to_id(task_name: str) -> int:
    assert task_name.startswith("Task"), \
        f"task name must start with 'Task', got {task_name}"
    return int(task_name[4:7])
