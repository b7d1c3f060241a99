"""Pretrained model install/registry.

Parity: reference inference/pretrained_models/download_pretrained_model.py
(:25-326 — URL registry + zip download/install) and
collect_pretrained_models.py (packaging trained models into zips).

The package makes no network call, so download_and_install raises;
install_model_from_zip / export_pretrained_model (the packaging side) are
fully functional.

The port's own copy of e2enet_tpu/inference/pretrained_models.py: the
same registry, the same zip layout and the same errors (KeyError for an
unknown task, RuntimeError otherwise); only the RuntimeError's words
differ. It imports nothing of the JAX package. export_pretrained_model
packs the files the port's trainer writes under the names the JAX
trainer uses (training/checkpoint.py), so a zip of either package
installs into the other.
"""
import os
import zipfile

from .. import paths
from ..utils.files import isdir, isfile, join, maybe_mkdir_p

# task -> released model URL + description: data-only port of the
# reference table (download_pretrained_model.py:25-326, 26 tasks); the
# URLs name each released zip, which install_model_from_zip_file installs.
PRETRAINED_MODEL_REGISTRY = {
    'Task001_BrainTumour': {
        "description": 'Brain Tumor Segmentation. \nSegmentation targets are edema, enhancing tumor and necrosis, \nInput modalities are 0: FLAIR, 1: T1, 2: T1 with contrast agent, 3: T2. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task001_BrainTumour.zip?download=1'},
    'Task002_Heart': {
        "description": 'Left Atrium Segmentation. \nSegmentation target is the left atrium, \nInput modalities are 0: MRI. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task002_Heart.zip?download=1'},
    'Task003_Liver': {
        "description": 'Liver and Liver Tumor Segmentation. \nSegmentation targets are liver and tumors, \nInput modalities are 0: abdominal CT scan. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task003_Liver.zip?download=1'},
    'Task004_Hippocampus': {
        "description": 'Hippocampus Segmentation. \nSegmentation targets posterior and anterior parts of the hippocampus, \nInput modalities are 0: MRI. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task004_Hippocampus.zip?download=1'},
    'Task005_Prostate': {
        "description": 'Prostate Segmentation. \nSegmentation targets are peripheral and central zone, \nInput modalities are 0: T2, 1: ADC. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4485926/files/Task005_Prostate.zip?download=1'},
    'Task006_Lung': {
        "description": 'Lung Nodule Segmentation. \nSegmentation target are lung nodules, \nInput modalities are 0: abdominal CT scan. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task006_Lung.zip?download=1'},
    'Task007_Pancreas': {
        "description": 'Pancreas Segmentation. \nSegmentation targets are pancras and pancreas tumor, \nInput modalities are 0: abdominal CT scan. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task007_Pancreas.zip?download=1'},
    'Task008_HepaticVessel': {
        "description": 'Hepatic Vessel Segmentation. \nSegmentation targets are hepatic vesels and liver tumors, \nInput modalities are 0: abdominal CT scan. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task008_HepaticVessel.zip?download=1'},
    'Task009_Spleen': {
        "description": 'Spleen Segmentation. \nSegmentation target is the spleen, \nInput modalities are 0: abdominal CT scan. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task009_Spleen.zip?download=1'},
    'Task010_Colon': {
        "description": 'Colon Cancer Segmentation. \nSegmentation target are colon caner primaries, \nInput modalities are 0: CT scan. \nAlso see Medical Segmentation Decathlon, http://medicaldecathlon.com/',
        "url": 'https://zenodo.org/record/4003545/files/Task010_Colon.zip?download=1'},
    'Task017_AbdominalOrganSegmentation': {
        "description": 'Multi-Atlas Labeling Beyond the Cranial Vault - Abdomen. \nSegmentation targets are thirteen different abdominal organs, \nInput modalities are 0: abdominal CT scan. \nAlso see https://www.synapse.org/#!Synapse:syn3193805/wiki/217754',
        "url": 'https://zenodo.org/record/4003545/files/Task017_AbdominalOrganSegmentation.zip?download=1'},
    'Task024_Promise': {
        "description": 'Prostate MR Image Segmentation 2012. \nSegmentation target is the prostate, \nInput modalities are 0: T2. \nAlso see https://promise12.grand-challenge.org/',
        "url": 'https://zenodo.org/record/4003545/files/Task024_Promise.zip?download=1'},
    'Task027_ACDC': {
        "description": 'Automatic Cardiac Diagnosis Challenge. \nSegmentation targets are right ventricle, left ventricular cavity and left myocardium, \nInput modalities are 0: cine MRI. \nAlso see https://acdc.creatis.insa-lyon.fr/',
        "url": 'https://zenodo.org/record/4003545/files/Task027_ACDC.zip?download=1'},
    'Task029_LiTS': {
        "description": 'Liver and Liver Tumor Segmentation Challenge. \nSegmentation targets are liver and liver tumors, \nInput modalities are 0: abdominal CT scan. \nAlso see https://competitions.codalab.org/competitions/17094',
        "url": 'https://zenodo.org/record/4003545/files/Task029_LITS.zip?download=1'},
    'Task035_ISBILesionSegmentation': {
        "description": 'Longitudinal multiple sclerosis lesion segmentation Challenge. \nSegmentation target is MS lesions, \ninput modalities are 0: FLAIR, 1: MPRAGE, 2: proton density, 3: T2. \nAlso see https://smart-stats-tools.org/lesion-challenge',
        "url": 'https://zenodo.org/record/4003545/files/Task035_ISBILesionSegmentation.zip?download=1'},
    'Task038_CHAOS_Task_3_5_Variant2': {
        "description": 'CHAOS - Combined (CT-MR) Healthy Abdominal Organ Segmentation Challenge (Task 3 & 5). \nSegmentation targets are left and right kidney, liver, spleen, \nInput modalities are 0: T1 in-phase, T1 out-phase, T2 (can be any of those)\nAlso see https://chaos.grand-challenge.org/',
        "url": 'https://zenodo.org/record/4003545/files/Task038_CHAOS_Task_3_5_Variant2.zip?download=1'},
    'Task048_KiTS_clean': {
        "description": 'Kidney and Kidney Tumor Segmentation Challenge. Segmentation targets kidney and kidney tumors, Input modalities are 0: abdominal CT scan. Also see https://kits19.grand-challenge.org/',
        "url": 'https://zenodo.org/record/4003545/files/Task048_KiTS_clean.zip?download=1'},
    'Task055_SegTHOR': {
        "description": 'SegTHOR: Segmentation of THoracic Organs at Risk in CT images. \nSegmentation targets are aorta, esophagus, heart and trachea, \nInput modalities are 0: CT scan. \nAlso see https://competitions.codalab.org/competitions/21145',
        "url": 'https://zenodo.org/record/4003545/files/Task055_SegTHOR.zip?download=1'},
    'Task061_CREMI': {
        "description": 'MICCAI Challenge on Circuit Reconstruction from Electron Microscopy Images (Synaptic Cleft segmentation task). \nSegmentation target is synaptic clefts, \nInput modalities are 0: serial section transmission electron microscopy of neural tissue. \nAlso see https://cremi.org/',
        "url": 'https://zenodo.org/record/4003545/files/Task061_CREMI.zip?download=1'},
    'Task075_Fluo_C3DH_A549_ManAndSim': {
        "description": 'Fluo-C3DH-A549-SIM and Fluo-C3DH-A549 datasets of the cell tracking challenge. Segmentation target are C3DH cells in fluorescence microscopy images.\nInput modalities are 0: fluorescence_microscopy\nAlso see http://celltrackingchallenge.net/',
        "url": 'https://zenodo.org/record/4003545/files/Task075_Fluo_C3DH_A549_ManAndSim.zip?download=1'},
    'Task076_Fluo_N3DH_SIM': {
        "description": 'Fluo-N3DH-SIM dataset of the cell tracking challenge. Segmentation target are N3DH cells and cell borders in fluorescence microscopy images.\nInput modalities are 0: fluorescence_microscopy\nAlso see http://celltrackingchallenge.net/\nNote that the segmentation output of the models are cell center and cell border. These outputs mus tbe converted to an instance segmentation for the challenge. \nSee https://github.com/MIC-DKFZ/nnUNet/blob/master/nnunet/dataset_conversion/Task076_Fluo_N3DH_SIM.py',
        "url": 'https://zenodo.org/record/4003545/files/Task076_Fluo_N3DH_SIM.zip?download=1'},
    'Task082_BraTS2020': {
        "description": 'Brain tumor segmentation challenge 2020 (BraTS)\nSegmentation targets are 0: background, 1: edema, 2: necrosis, 3: enhancing tumor\nInput modalities are 0: T1, 1: T1ce, 2: T2, 3: FLAIR (MRI images)\nAlso see https://www.med.upenn.edu/cbica/brats2020/',
        "url": ('https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2__nnUNetPlansv2.1_5fold.zip?download=1', 'https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2BraTSRegions_DA3_BN_BD__nnUNetPlansv2.1_bs5_5fold.zip?download=1', 'https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2BraTSRegions_DA4_BN__nnUNetPlansv2.1_bs5_15fold.zip?download=1', 'https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2BraTSRegions_DA4_BN_BD__nnUNetPlansv2.1_bs5_5fold.zip?download=1')},
    'Task089_Fluo-N2DH-SIM_thickborder_time': {
        "description": 'Fluo-N2DH-SIM dataset of the cell tracking challenge. Segmentation target are nuclei of N2DH cells and cell borders in fluorescence microscopy images.\nInput modalities are 0: t minus 4, 0: t minus 3, 0: t minus 2, 0: t minus 1, 0: frame of interest\nNote that the input channels are different time steps from a time series acquisition\nNote that the segmentation output of the models are cell center and cell border. These outputs mus tbe converted to an instance segmentation for the challenge. \nSee https://github.com/MIC-DKFZ/nnUNet/blob/master/nnunet/dataset_conversion/Task089_Fluo-N2DH-SIM.py\nAlso see http://celltrackingchallenge.net/',
        "url": 'https://zenodo.org/record/4003545/files/Task089_Fluo-N2DH-SIM_thickborder_time.zip?download=1'},
    'Task114_heart_MNMs': {
        "description": 'Cardiac MRI short axis images from the M&Ms challenge 2020.\nInput modalities are 0: MRI \nSee also https://www.ub.edu/mnms/ \nNote: Labels of the M&Ms Challenge are not in the same order as for the ACDC challenge. \nSee https://github.com/MIC-DKFZ/nnUNet/blob/master/nnunet/dataset_conversion/Task114_heart_mnms.py',
        "url": 'https://zenodo.org/record/4288464/files/Task114_heart_MNMs.zip?download=1'},
    'Task115_COVIDSegChallenge': {
        "description": 'Covid lesion segmentation in CT images. Data originates from COVID-19-20 challenge.\nPredicted labels are 0: background, 1: covid lesion\nInput modalities are 0: CT \nSee also https://covid-segmentation.grand-challenge.org/',
        "url": ('https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_DA3__nnUNetPlans_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_DA3_BN__nnUNetPlans_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_ResencUNet__nnUNetPlans_FabiansResUNet_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_ResencUNet_DA3__nnUNetPlans_FabiansResUNet_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_ResencUNet_DA3_BN__nnUNetPlans_FabiansResUNet_v2.1__3d_lowres__10folds.zip?download=1')},
    'Task135_KiTS2021': {
        "description": 'Kidney and kidney tumor segmentation in CT images. Data originates from KiTS2021 challenge.\nPredicted labels are 0: background, 1: kidney, 2: tumor, 3: cyst \nInput modalities are 0: CT \nSee also https://kits21.kits-challenge.org/',
        "url": ('https://zenodo.org/record/5126443/files/Task135_KiTS2021.zip?download=1',)},
}


def print_available_pretrained_models():
    if not PRETRAINED_MODEL_REGISTRY:
        print("No pretrained models registered yet.")
    for k, v in PRETRAINED_MODEL_REGISTRY.items():
        print(k, "->", v.get("description", v.get("url")))


def install_model_from_zip_file(zip_file: str):
    results = paths.require(paths.get_results_dir(), "RESULTS_FOLDER")
    maybe_mkdir_p(results)
    with zipfile.ZipFile(zip_file, "r") as zf:
        zf.extractall(results)
    print(f"installed {zip_file} -> {results}")


def download_and_install_pretrained_model_by_name(task_name: str):
    if task_name not in PRETRAINED_MODEL_REGISTRY:
        raise KeyError(
            f"no pretrained model registered for {task_name}; known: "
            f"{sorted(PRETRAINED_MODEL_REGISTRY)}")
    raise RuntimeError(
        "this package downloads nothing; fetch the zip with another tool "
        "and use install_model_from_zip_file()")


def export_pretrained_model(task_name: str, output_file: str,
                            networks=("3d_fullres",),
                            trainer_plan: str = "TPUTrainer__nnUNetPlansv2.1",
                            folds=(0, 1, 2, 3, 4),
                            tconv: str = "shiftConvPP",
                            checkpoint: str = "model_final_checkpoint"):
    """Package trained folds (+ plans/postprocessing) into an installable
    zip (collect_pretrained_models.py equivalent)."""
    results = paths.require(paths.get_results_dir(), "RESULTS_FOLDER")
    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED) as zf:
        for net in networks:
            base = join(results, net, task_name, trainer_plan)
            assert isdir(base), f"missing trained model: {base}"
            for fname in ("plans.json", "postprocessing.json"):
                p = join(base, fname)
                if isfile(p):
                    zf.write(p, os.path.relpath(p, results))
            for f in folds:
                fd = join(base, f"fold_{f}")
                if not isdir(fd):
                    continue
                for fname in (f"{tconv}_{checkpoint}.model",
                              f"{tconv}_{checkpoint}.model.pkl",
                              "debug.json", "progress.png"):
                    p = join(fd, fname)
                    if isfile(p):
                        zf.write(p, os.path.relpath(p, results))
    print(f"exported {task_name} -> {output_file}")
    return output_file
