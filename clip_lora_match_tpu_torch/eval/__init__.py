from clip_lora_match_tpu_torch.eval.comparator import BASE_NAME, ModelComparator, epoch_name
from clip_lora_match_tpu_torch.eval.evaluator import CLIPEvaluator, EvalData, load_eval_csv
from clip_lora_match_tpu_torch.eval.protocols import (
    diagonal_metrics,
    relative_improvement,
    similarity_matrix,
    threshold_metrics,
)
from clip_lora_match_tpu_torch.eval.qualitative import (
    FailureCase,
    find_failure_cases,
    plot_embedding_space,
    plot_failure_grids,
)
from clip_lora_match_tpu_torch.eval.report import create_evaluation_report

__all__ = [
    "BASE_NAME",
    "ModelComparator",
    "epoch_name",
    "CLIPEvaluator",
    "EvalData",
    "load_eval_csv",
    "diagonal_metrics",
    "relative_improvement",
    "similarity_matrix",
    "threshold_metrics",
    "FailureCase",
    "find_failure_cases",
    "plot_embedding_space",
    "plot_failure_grids",
    "create_evaluation_report",
]
