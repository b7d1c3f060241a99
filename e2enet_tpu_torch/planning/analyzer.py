"""Dataset fingerprinting: sizes/spacings after crop, class inventory,
foreground intensity statistics, crop size reductions.

Parity: reference e2enet/experiment_planning/DatasetAnalyzer.py:27-262.
Writes dataset_properties.pkl into the cropped-data folder, the input of the
experiment planner.

The port's own copy of e2enet_tpu/planning/analyzer.py, unchanged but for this note:
the port imports nothing of the JAX package.
"""
from collections import OrderedDict
import os

import numpy as np

from ..configuration import default_num_threads
from ..utils.files import (isfile, join, load_json, load_pickle, save_pickle,
                           subfiles)


def get_patient_identifiers_from_cropped_files(folder):
    return [os.path.basename(i)[:-4]
            for i in subfiles(folder, join=True, suffix=".npz")]


class DatasetAnalyzer:
    def __init__(self, folder_with_cropped_data, overwrite=True,
                 num_processes=default_num_threads):
        self.num_processes = num_processes
        self.overwrite = overwrite
        self.folder_with_cropped_data = folder_with_cropped_data
        self.patient_identifiers = \
            get_patient_identifiers_from_cropped_files(
                self.folder_with_cropped_data)
        assert isfile(join(self.folder_with_cropped_data, "dataset.json")), \
            "dataset.json needs to be in folder_with_cropped_data"
        self.props_per_case_file = join(self.folder_with_cropped_data,
                                        "props_per_case.pkl")
        self.intensityproperties_file = join(self.folder_with_cropped_data,
                                             "intensityproperties.pkl")

    def load_properties_of_cropped(self, case_identifier):
        return load_pickle(join(self.folder_with_cropped_data,
                                f"{case_identifier}.pkl"))

    def get_classes(self):
        datasetjson = load_json(join(self.folder_with_cropped_data,
                                     "dataset.json"))
        return datasetjson["labels"]

    def get_modalities(self):
        datasetjson = load_json(join(self.folder_with_cropped_data,
                                     "dataset.json"))
        modalities = datasetjson["modality"]
        return {int(k): modalities[k] for k in modalities}

    def get_sizes_and_spacings_after_cropping(self):
        sizes = []
        spacings = []
        for c in self.patient_identifiers:
            properties = self.load_properties_of_cropped(c)
            sizes.append(properties["size_after_cropping"])
            spacings.append(properties["original_spacing"])
        return sizes, spacings

    def get_size_reduction_by_cropping(self):
        size_reduction = OrderedDict()
        for p in self.patient_identifiers:
            props = self.load_properties_of_cropped(p)
            shape_before_crop = props["original_size_of_raw_data"]
            shape_after_crop = props["size_after_cropping"]
            size_reduction[p] = (np.prod(shape_after_crop)
                                 / np.prod(shape_before_crop))
        return size_reduction

    def _get_unique_labels(self, patient_identifier):
        seg = np.load(join(self.folder_with_cropped_data,
                           patient_identifier) + ".npz")["data"][-1]
        return np.unique(seg)

    def analyse_segmentations(self):
        class_dct = self.get_classes()
        if self.overwrite or not isfile(self.props_per_case_file):
            res = [self._get_unique_labels(p)
                   for p in self.patient_identifiers]
            props_per_patient = OrderedDict()
            for p, unique_classes in zip(self.patient_identifiers, res):
                props = OrderedDict()
                props["has_classes"] = unique_classes
                props_per_patient[p] = props
            save_pickle(props_per_patient, self.props_per_case_file)
        else:
            props_per_patient = load_pickle(self.props_per_case_file)
        return class_dct, props_per_patient

    def _get_voxels_in_foreground(self, patient_identifier, modality_id):
        all_data = np.load(join(self.folder_with_cropped_data,
                                patient_identifier) + ".npz")["data"]
        modality = all_data[modality_id]
        mask = all_data[-1] > 0
        # every 10th foreground voxel suffices for the statistics
        return list(modality[mask][::10])

    @staticmethod
    def _compute_stats(voxels):
        if len(voxels) == 0:
            return (np.nan,) * 7
        return (np.median(voxels), np.mean(voxels), np.std(voxels),
                np.min(voxels), np.max(voxels),
                np.percentile(voxels, 99.5), np.percentile(voxels, 0.5))

    def collect_intensity_properties(self, num_modalities):
        if self.overwrite or not isfile(self.intensityproperties_file):
            results = OrderedDict()
            for mod_id in range(num_modalities):
                results[mod_id] = OrderedDict()
                v = [self._get_voxels_in_foreground(p, mod_id)
                     for p in self.patient_identifiers]
                w = []
                for iv in v:
                    w += iv
                (median, mean, sd, mn, mx, percentile_99_5,
                 percentile_00_5) = self._compute_stats(w)
                props_per_case = OrderedDict()
                for pat, voxels in zip(self.patient_identifiers, v):
                    st = self._compute_stats(voxels)
                    props_per_case[pat] = OrderedDict(
                        median=st[0], mean=st[1], sd=st[2], mn=st[3],
                        mx=st[4], percentile_99_5=st[5],
                        percentile_00_5=st[6])
                results[mod_id]["local_props"] = props_per_case
                results[mod_id]["median"] = median
                results[mod_id]["mean"] = mean
                results[mod_id]["sd"] = sd
                results[mod_id]["mn"] = mn
                results[mod_id]["mx"] = mx
                results[mod_id]["percentile_99_5"] = percentile_99_5
                results[mod_id]["percentile_00_5"] = percentile_00_5
            save_pickle(results, self.intensityproperties_file)
        else:
            results = load_pickle(self.intensityproperties_file)
        return results

    def analyze_dataset(self, collect_intensityproperties=True):
        sizes, spacings = self.get_sizes_and_spacings_after_cropping()
        classes = self.get_classes()
        all_classes = [int(i) for i in classes.keys() if int(i) > 0]
        modalities = self.get_modalities()
        self.analyse_segmentations()

        if collect_intensityproperties:
            intensityproperties = self.collect_intensity_properties(
                len(modalities))
        else:
            intensityproperties = None
        size_reductions = self.get_size_reduction_by_cropping()

        dataset_properties = dict()
        dataset_properties["all_sizes"] = sizes
        dataset_properties["all_spacings"] = spacings
        dataset_properties["all_classes"] = all_classes
        dataset_properties["modalities"] = modalities
        dataset_properties["intensityproperties"] = intensityproperties
        dataset_properties["size_reductions"] = size_reductions
        save_pickle(dataset_properties,
                    join(self.folder_with_cropped_data,
                         "dataset_properties.pkl"))
        return dataset_properties
