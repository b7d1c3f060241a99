"""Plan & preprocess CLI: crop -> fingerprint -> plan -> preprocess.

Parity: reference e2enet/experiment_planning/nnUNet_plan_and_preprocess.py
(:27-168) + experiment_planning/utils.py crop() (:122).

Usage:
  python -m e2enet_tpu_torch.cli.plan_and_preprocess -t 4
      [-pl3d ExperimentPlanner3D_v21] [-pl2d ExperimentPlanner2D_v21]
      [-no_pp] [--verify_dataset_integrity] [-tl N] [-tf N]

Reads $nnUNet_raw_data_base/nnUNet_raw_data/<task>/ (imagesTr/,
labelsTr/, dataset.json), writes the cropped cases under
$nnUNet_raw_data_base/nnUNet_cropped_data/<task>/ and the plans and stage
folders under $nnUNet_preprocessed/<task>/, the folder the train CLI
reads. All of it is host work (numpy, scipy): no card is needed or used.

The port's own copy of e2enet_tpu/cli/plan_and_preprocess.py, unchanged
but for this note and the usage above: the port imports nothing of the JAX
package.
"""
import argparse
import shutil

from .. import paths
from ..configuration import default_num_threads
from ..planning.analyzer import DatasetAnalyzer
# imported for their registration side effects
from ..planning import planner as _planner_mod  # noqa: F401
from ..planning import planner2d as _planner2d_mod  # noqa: F401
from ..planning import alternative_planners as _alt_planners  # noqa: F401
from ..preprocessing.cropping import ImageCropper
from ..utils.files import join, load_json, maybe_mkdir_p
from ..utils.registry import PLANNERS
from ..utils.task_names import convert_id_to_task_name


def create_lists_from_splitted_dataset(base_folder_splitted):
    lists = []
    json_file = join(base_folder_splitted, "dataset.json")
    d = load_json(json_file)
    training_files = d["training"]
    num_modalities = len(d["modality"].keys())
    for tr in training_files:
        cur_pat = []
        image_id = tr["image"].split("/")[-1].split(".nii.gz")[0]
        for mod in range(num_modalities):
            cur_pat.append(join(base_folder_splitted, "imagesTr",
                                image_id + "_%04.0d.nii.gz" % mod))
        cur_pat.append(join(base_folder_splitted, "labelsTr",
                            tr["label"].split("/")[-1]))
        lists.append(cur_pat)
    return lists, {int(i): d["modality"][str(i)] for i in d["modality"]}


def crop(task_string, override=False, num_threads=default_num_threads):
    cropped_out_dir = join(paths.require(paths.get_cropped_data_dir(),
                                         "cropped data dir"), task_string)
    maybe_mkdir_p(cropped_out_dir)
    splitted_4d_output_dir_task = join(
        paths.require(paths.get_raw_data_dir(), "raw data dir"), task_string)
    lists, _ = create_lists_from_splitted_dataset(
        splitted_4d_output_dir_task)
    imgcrop = ImageCropper(num_threads, cropped_out_dir)
    imgcrop.run_cropping(lists, overwrite_existing=override)
    shutil.copy(join(splitted_4d_output_dir_task, "dataset.json"),
                cropped_out_dir)


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-t", "--task_ids", nargs="+",
                        help="task ids to plan+preprocess")
    parser.add_argument("-pl3d", "--planner3d", type=str,
                        default="ExperimentPlanner3D_v21")
    parser.add_argument("-pl2d", "--planner2d", type=str, default="None",
                        help="e.g. ExperimentPlanner2D_v21 ('None' skips 2D)")
    parser.add_argument("-no_pp", action="store_true",
                        help="only plan, skip preprocessing")
    parser.add_argument("-tl", type=int, default=default_num_threads,
                        help="low-res preprocessing threads")
    parser.add_argument("-tf", type=int, default=default_num_threads,
                        help="full-res preprocessing threads")
    parser.add_argument("--verify_dataset_integrity", action="store_true")
    parser.add_argument("-overwrite_plans", default=None)
    a = parser.parse_args(args)

    for task_id in a.task_ids:
        task_name = convert_id_to_task_name(int(task_id))
        if a.verify_dataset_integrity:
            from ..planning.sanity import verify_dataset_integrity
            verify_dataset_integrity(join(paths.get_raw_data_dir(),
                                          task_name))
        print("\n\n\n", task_name)
        crop(task_name, False, a.tf)

        cropped_out_dir = join(paths.get_cropped_data_dir(), task_name)
        preprocessing_output_dir_this_task = join(
            paths.require(paths.get_preprocessing_output_dir(),
                          "preprocessed dir"), task_name)

        dataset_analyzer = DatasetAnalyzer(cropped_out_dir, overwrite=False,
                                           num_processes=a.tf)
        dataset_json = load_json(join(cropped_out_dir, "dataset.json"))
        modalities = list(dataset_json["modality"].values())
        collect_intensityproperties = True if (("CT" in modalities)
                                               or ("ct" in modalities)) \
            else False
        dataset_analyzer.analyze_dataset(collect_intensityproperties)

        maybe_mkdir_p(preprocessing_output_dir_this_task)
        shutil.copy(join(cropped_out_dir, "dataset_properties.pkl"),
                    preprocessing_output_dir_this_task)
        shutil.copy(join(paths.get_raw_data_dir(), task_name,
                         "dataset.json"),
                    preprocessing_output_dir_this_task)

        if a.planner3d != "None":
            planner_cls = PLANNERS.get(a.planner3d)
            planner = planner_cls(cropped_out_dir,
                                  preprocessing_output_dir_this_task)
            planner.plan_experiment()
            if not a.no_pp:
                planner.run_preprocessing((a.tl, a.tf))
        if a.planner2d != "None":
            planner_cls = PLANNERS.get(a.planner2d)
            planner = planner_cls(cropped_out_dir,
                                  preprocessing_output_dir_this_task)
            planner.plan_experiment()
            if not a.no_pp:
                planner.run_preprocessing(a.tf)


if __name__ == "__main__":
    main()
