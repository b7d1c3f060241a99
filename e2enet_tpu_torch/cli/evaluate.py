"""Evaluate CLI: folder-vs-folder metric aggregation -> summary.json.

Parity: reference evaluator.py nnunet_evaluate_folder (:471-506).

The port's own copy of e2enet_tpu/cli/evaluate.py (host code: numpy and
scipy, no card).

Usage:
  python -m e2enet_tpu_torch.cli.evaluate -ref LABELS_DIR -pred PRED_DIR \
      -l 1 2 3
"""
import argparse

from ..evaluation.evaluator import evaluate_folder


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Evaluates segmentations in -pred against ground truth "
                    "in -ref; writes summary.json into -pred")
    parser.add_argument("-ref", required=True, help="ground-truth folder")
    parser.add_argument("-pred", required=True, help="predictions folder")
    parser.add_argument("-l", nargs="+", type=int, required=True,
                        help="labels to evaluate, e.g. -l 1 2 3 4")
    a = parser.parse_args(args)
    evaluate_folder(a.ref, a.pred, a.l)


if __name__ == "__main__":
    main()
