"""3D patch sampler with forced-foreground oversampling.

Parity: reference DataLoader3D
(training/dataloading/dataset_loading.py:163-387): random case per batch
element; the last ceil(33%) of the batch is forced to contain foreground by
centering the patch on a precomputed `class_locations` voxel of a randomly
chosen present class; bbox may extend past the volume and is padded (data:
constant 0 via pad_mode='constant' in the trainer, seg: constant -1).

The port's own copy of e2enet_tpu/data/sampler.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
from typing import Dict, Optional, Sequence

import numpy as np

from .dataset import load_case
from ..utils.files import load_pickle


class PatchSampler3D:
    def __init__(self, dataset: Dict[str, dict], patch_size: Sequence[int],
                 final_patch_size: Sequence[int], batch_size: int,
                 has_prev_stage: bool = False,
                 oversample_foreground_percent: float = 0.33,
                 memmap_mode: str = "r", pad_mode: str = "constant",
                 pad_sides=None, seed: Optional[int] = None):
        self._data = dataset
        self.has_prev_stage = has_prev_stage
        self.patch_size = np.array(patch_size).astype(int)
        self.final_patch_size = np.array(final_patch_size).astype(int)
        self.batch_size = batch_size
        self.oversample_foreground_percent = oversample_foreground_percent
        self.memmap_mode = memmap_mode
        self.pad_mode = pad_mode
        self.list_of_keys = list(self._data.keys())
        self.need_to_pad = (self.patch_size - self.final_patch_size).astype(int)
        if pad_sides is not None:
            self.need_to_pad += np.array(pad_sides)
        self.rng = np.random.RandomState(seed)
        self.data_shape, self.seg_shape = self._determine_shapes()
        self._properties_cache = {}

    def _determine_shapes(self):
        k = self.list_of_keys[0]
        case_all_data = load_case(self._data[k], self.memmap_mode)
        num_color_channels = case_all_data.shape[0] - 1
        num_seg = 2 if self.has_prev_stage else 1
        data_shape = (self.batch_size, num_color_channels, *self.patch_size)
        seg_shape = (self.batch_size, num_seg, *self.patch_size)
        return data_shape, seg_shape

    def _properties(self, key):
        if key not in self._properties_cache:
            self._properties_cache[key] = load_pickle(
                self._data[key]["properties_file"])
        return self._properties_cache[key]

    def get_do_oversample(self, batch_idx: int) -> bool:
        return not batch_idx < round(
            self.batch_size * (1 - self.oversample_foreground_percent))

    def generate_train_batch(self):
        selected_keys = self.rng.choice(self.list_of_keys, self.batch_size,
                                        True, None)
        data = np.zeros(self.data_shape, dtype=np.float32)
        seg = np.zeros(self.seg_shape, dtype=np.float32)
        case_properties = []
        for j, i in enumerate(selected_keys):
            force_fg = self.get_do_oversample(j)
            properties = self._properties(i)
            case_properties.append(properties)
            case_all_data = load_case(self._data[i], self.memmap_mode)

            seg_from_prev = None
            if self.has_prev_stage:
                # <case>_segFromPrevStage.npz next to the data file
                # (cascade_stuff/predict_next_stage.py output)
                pf = self._data[i]["data_file"][:-4] + "_segFromPrevStage.npz"
                import os as _os
                npy = pf[:-4] + ".npy"
                if _os.path.isfile(npy):
                    seg_from_prev = np.load(npy, mmap_mode=self.memmap_mode)
                else:
                    seg_from_prev = np.load(pf)["data"]

            need_to_pad = self.need_to_pad.copy()
            for d in range(3):
                if need_to_pad[d] + case_all_data.shape[d + 1] < \
                        self.patch_size[d]:
                    need_to_pad[d] = self.patch_size[d] - \
                        case_all_data.shape[d + 1]

            shape = case_all_data.shape[1:]
            lbs = [-need_to_pad[d] // 2 for d in range(3)]
            ubs = [shape[d] + need_to_pad[d] // 2 + need_to_pad[d] % 2
                   - self.patch_size[d] for d in range(3)]

            if not force_fg:
                bbox_lbs = [self.rng.randint(lbs[d], ubs[d] + 1)
                            for d in range(3)]
            else:
                cls_locs = properties.get("class_locations", {})
                foreground_classes = np.array(
                    [c for c in cls_locs.keys() if len(cls_locs[c]) != 0])
                foreground_classes = foreground_classes[
                    foreground_classes > 0]
                if len(foreground_classes) == 0:
                    bbox_lbs = [self.rng.randint(lbs[d], ubs[d] + 1)
                                for d in range(3)]
                else:
                    selected_class = self.rng.choice(foreground_classes)
                    voxels = cls_locs[selected_class]
                    sel = voxels[self.rng.choice(len(voxels))]
                    bbox_lbs = [max(lbs[d],
                                    sel[d] - self.patch_size[d] // 2)
                                for d in range(3)]

            bbox_ubs = [bbox_lbs[d] + self.patch_size[d] for d in range(3)]
            valid_lbs = [max(0, bbox_lbs[d]) for d in range(3)]
            valid_ubs = [min(shape[d], bbox_ubs[d]) for d in range(3)]

            case_all_data = np.copy(case_all_data[
                :, valid_lbs[0]:valid_ubs[0], valid_lbs[1]:valid_ubs[1],
                valid_lbs[2]:valid_ubs[2]])

            pad_spec = [(0, 0)] + [
                (-min(0, bbox_lbs[d]), max(bbox_ubs[d] - shape[d], 0))
                for d in range(3)]
            data[j] = np.pad(case_all_data[:-1], pad_spec, self.pad_mode)
            seg[j, 0] = np.pad(case_all_data[-1:], pad_spec, "constant",
                               constant_values=-1)[0]
            if seg_from_prev is not None:
                sp = seg_from_prev[valid_lbs[0]:valid_ubs[0],
                                   valid_lbs[1]:valid_ubs[1],
                                   valid_lbs[2]:valid_ubs[2]][None]
                seg[j, 1] = np.pad(sp, pad_spec, "constant",
                                   constant_values=0)[0]

        return {"data": data, "seg": seg, "properties": case_properties,
                "keys": selected_keys}
