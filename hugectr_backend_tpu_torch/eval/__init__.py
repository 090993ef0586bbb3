"""Training and evaluation harnesses: the AUC-parity harness of
:mod:`~hugectr_backend_tpu_torch.eval.auc_parity`."""

from hugectr_backend_tpu_torch.eval.auc_parity import (
    VARIANTS,
    ClickDataset,
    DlrmTrainer,
    MultiClickDataset,
    auc,
    dlrm_loss,
    make_click_dataset,
    make_multi_click_dataset,
    make_trainer,
    multi_serving_scores,
    run_parity,
    run_path_parity,
    serving_scores,
    train_dlrm,
    train_dlrm_multi,
)

__all__ = [
    "VARIANTS",
    "ClickDataset",
    "DlrmTrainer",
    "MultiClickDataset",
    "auc",
    "dlrm_loss",
    "make_click_dataset",
    "make_multi_click_dataset",
    "make_trainer",
    "multi_serving_scores",
    "run_parity",
    "run_path_parity",
    "serving_scores",
    "train_dlrm",
    "train_dlrm_multi",
]
