"""Typed configuration tree, YAML-loadable with the JAX package's keys.

The port's own copy of the parts of ``clip_lora_match_tpu/core/config.py`` the
serving path needs: ``ClipArchConfig`` (with the same presets), ``ClipConfig``,
``PreprocessConfig``, ``LoraConfig`` and ``load_clip_config``, parsing the same
``config/clip_config.yaml``; ``YoloConfig`` with ``load_yolo_config`` for
``config/yolo_config.yaml``; ``DBConfig`` with ``load_db_config`` for
``config/db_config.yaml``; ``TrainingConfig`` with ``load_lora_config`` for
``config/lora_config.yaml`` (its ``model:``, ``lora:``, ``data:`` and
``training:`` blocks); ``EvalConfig`` with ``load_eval_config`` for
``config/evaluation_config.yaml``; and ``to_dict``. Unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import yaml

# CLIP normalization constants (config/clip_config.yaml preprocess block).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class ClipArchConfig:
    """Architecture hyper-parameters of the CLIP dual tower (ViT-B/32 default)."""

    # Vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp_dim: int = 3072
    # Text tower
    vocab_size: int = 49408
    max_text_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_mlp_dim: int = 2048
    # Shared
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    logit_scale_init: float = 2.6592  # ln(1/0.07)

    @property
    def vision_seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1  # +1 class token


VIT_B32 = ClipArchConfig()
VIT_B16 = ClipArchConfig(patch_size=16)
VIT_L14 = ClipArchConfig(
    patch_size=14,
    vision_width=1024,
    vision_layers=24,
    vision_heads=16,
    vision_mlp_dim=4096,
    text_width=768,
    text_heads=12,
    text_mlp_dim=3072,
    projection_dim=768,
)
VIT_L14_336 = dataclasses.replace(VIT_L14, image_size=336)

ARCH_PRESETS = {
    "openai/clip-vit-base-patch32": VIT_B32,
    "openai/clip-vit-base-patch16": VIT_B16,
    "openai/clip-vit-large-patch14": VIT_L14,
    "openai/clip-vit-large-patch14-336": VIT_L14_336,
}


def arch_for_model_name(name: str) -> ClipArchConfig:
    """Resolve a CLIP model name to its preset; unknown names warn and fall
    back to ViT-B/32."""
    if name in ARCH_PRESETS:
        return ARCH_PRESETS[name]
    warnings.warn(
        f"unknown CLIP model name {name!r}; assuming ViT-B/32 geometry "
        f"(known: {sorted(ARCH_PRESETS)})"
    )
    return VIT_B32


@dataclass(frozen=True)
class PreprocessConfig:
    """Mirrors the ``preprocess:`` block of config/clip_config.yaml."""

    image_size: int = 224
    center_crop: bool = True
    mean: Sequence[float] = CLIP_IMAGE_MEAN
    std: Sequence[float] = CLIP_IMAGE_STD
    max_text_length: int = 77
    truncate: bool = True


@dataclass(frozen=True)
class ClipConfig:
    """Mirrors config/clip_config.yaml (model/preprocess/paths/inference).
    ``device`` is read and kept so that one YAML serves both packages; the
    port's encoder runs on the device its caller names (``"cuda"`` by
    default), whatever this field says."""

    model_name: str = "openai/clip-vit-base-patch32"
    pretrained: bool = True
    device: str = "tpu"
    dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # matmul dtype on CUDA; fp32 accumulate
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)
    lora_weights_dir: str = "models/clip/lora"
    checkpoints_dir: str = "models/saved"
    logs_dir: str = "logs/clip"
    batch_size: int = 16
    num_workers: int = 4
    arch: Optional[ClipArchConfig] = None
    tokenizer_dir: Optional[str] = None
    # dispatch the hand-written CUDA kernels inside the towers on CUDA
    use_pallas_kernels: bool = True
    # serving quantization of the transformer-block linears: "none" (default)
    # or "int8" (W8A8, quant/int8.py)
    quantize: str = "none"
    # the JAX package's persistent XLA compilation cache directory. Read and
    # kept so that one YAML serves both packages; it has no effect in PyTorch,
    # which compiles no graphs (the CUDA kernels' build cache is build/).
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        if self.arch is None:
            object.__setattr__(self, "arch", arch_for_model_name(self.model_name))
        if self.preprocess.image_size != self.arch.image_size:
            object.__setattr__(
                self,
                "preprocess",
                dataclasses.replace(self.preprocess, image_size=self.arch.image_size),
            )


@dataclass(frozen=True)
class LoraConfig:
    """Mirrors config/lora_config.yaml lora/model blocks (r=8, alpha=16,
    dropout 0.1, bias none, FEATURE_EXTRACTION, q/k/v/out_proj)."""

    r: int = 8
    alpha: int = 16
    dropout: float = 0.1
    bias: str = "none"
    task_type: str = "FEATURE_EXTRACTION"
    target_modules: Sequence[str] = ("q_proj", "k_proj", "v_proj", "out_proj")
    base_model_name: str = "openai/clip-vit-base-patch32"

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


@dataclass(frozen=True)
class TrainingConfig:
    """Mirrors the ``training:`` and ``data:`` blocks of
    config/lora_config.yaml, every field of the JAX package's
    ``TrainingConfig`` with its default (the reference recipe: seed 42,
    AdamW lr 1e-4, wd 0.01, warmup ratio 0.1, clip 1.0, temperature 0.07).

    ``remat``: False, True (each block checkpointed with
    ``torch.utils.checkpoint``) or ``"dots"`` (selective checkpointing that
    saves the matmul outputs). ``text_seq_slice``: text columns that are padding in every row of a
    batch are dropped down to this width (0: never); exact under the causal
    mask. ``chain_steps``, ``scan_unroll`` and ``dropout_rng_impl`` are read
    and kept so that one YAML serves both packages; they have no effect in
    PyTorch, which runs eagerly (a chain of K steps saves no dispatch, so
    ``train()`` calls the single step per batch, the trajectory of
    ``make_chained_train_step``), runs the layers as a Python loop and draws
    dropout masks from ``torch.Generator``s. ``global_batch_size`` and
    ``checkpoint_every_steps`` are read and unused, as in the JAX trainer."""

    seed: int = 42
    batch_size: int = 8
    num_workers: int = 2
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    num_epochs: int = 1
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    logging_steps: int = 50
    temperature: float = 0.07
    warmup_ratio: float = 0.1
    output_dir: str = "models/saved/clip-lora"
    train_csv: str = "data/text/train_fashion.csv"
    val_csv: str = "data/text/val_fashion.csv"
    image_root_dir: str = "."
    global_batch_size: Optional[int] = None
    checkpoint_every_steps: Optional[int] = None
    resume: bool = True
    remat: Any = False
    scan_unroll: Any = True
    dropout_rng_impl: Optional[str] = None
    chain_steps: int = 1
    text_seq_slice: int = 64


def _read_yaml(path: str) -> dict:
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def load_clip_config(path: Optional[str] = None) -> ClipConfig:
    """Parse the config/clip_config.yaml shape; a missing path gives defaults."""
    if path is None or not os.path.exists(path):
        return ClipConfig()
    raw = _read_yaml(path)
    model = raw.get("model", {}) or {}
    pre = raw.get("preprocess", {}) or {}
    paths = raw.get("paths", {}) or {}
    inf = raw.get("inference", {}) or {}
    norm = pre.get("normalize", {}) or {}
    preprocess = PreprocessConfig(
        image_size=pre.get("image_size", 224),
        center_crop=pre.get("center_crop", True),
        mean=tuple(norm.get("mean", CLIP_IMAGE_MEAN)),
        std=tuple(norm.get("std", CLIP_IMAGE_STD)),
        max_text_length=pre.get("max_text_length", 77),
        truncate=pre.get("truncate", True),
    )
    return ClipConfig(
        model_name=model.get("name", "openai/clip-vit-base-patch32"),
        pretrained=model.get("pretrained", True),
        device=model.get("device", "tpu"),
        dtype=model.get("dtype", "float32"),
        compute_dtype=model.get("compute_dtype", "bfloat16"),
        preprocess=preprocess,
        lora_weights_dir=paths.get("lora_weights_dir", "models/clip/lora"),
        checkpoints_dir=paths.get("checkpoints_dir", "models/saved"),
        logs_dir=paths.get("logs_dir", "logs/clip"),
        batch_size=inf.get("batch_size", 16),
        num_workers=inf.get("num_workers", 4),
        tokenizer_dir=model.get("tokenizer_dir"),
        use_pallas_kernels=model.get("use_pallas_kernels", True),
        quantize=model.get("quantize", "none"),
        compilation_cache_dir=model.get("compilation_cache_dir"),
        arch=_arch_from_yaml(model),
    )


def load_lora_config(path: Optional[str] = None) -> tuple[LoraConfig, TrainingConfig]:
    """Parse the config/lora_config.yaml shape; returns (lora, training). A
    missing path gives the defaults. ``model.target_modules`` defaults to
    q/v only when the file omits it, as in the JAX package."""
    if path is None or not os.path.exists(path):
        return LoraConfig(), TrainingConfig()
    raw = _read_yaml(path)
    model = raw.get("model", {}) or {}
    lora = raw.get("lora", {}) or {}
    data = raw.get("data", {}) or {}
    tr = raw.get("training", {}) or {}
    lora_cfg = LoraConfig(
        r=lora.get("r", 8),
        alpha=lora.get("alpha", 16),
        dropout=lora.get("dropout", 0.1),
        bias=lora.get("bias", "none"),
        task_type=lora.get("task_type", "FEATURE_EXTRACTION"),
        target_modules=tuple(model.get("target_modules", ("q_proj", "v_proj"))),
        base_model_name=model.get("base_model_name", "openai/clip-vit-base-patch32"),
    )
    names = {f.name for f in dataclasses.fields(TrainingConfig)}
    fields = {
        **tr,
        # YAML reads 1e-4 without a dot as a string
        "learning_rate": float(tr.get("learning_rate", 1e-4)),
        "weight_decay": float(tr.get("weight_decay", 0.01)),
        "train_csv": data.get("train_csv", "data/text/train_fashion.csv"),
        "val_csv": data.get("val_csv", "data/text/val_fashion.csv"),
        "image_root_dir": data.get("image_root_dir", "."),
    }
    return lora_cfg, TrainingConfig(**{k: v for k, v in fields.items() if k in names})


def _arch_from_yaml(model: dict) -> Optional[ClipArchConfig]:
    """Optional ``model.arch:`` override block; None resolves from the name."""
    block = model.get("arch")
    if not block:
        return None
    base = arch_for_model_name(model.get("name", "openai/clip-vit-base-patch32"))
    known = {f.name for f in dataclasses.fields(ClipArchConfig)}
    unknown = sorted(set(block) - known)
    if unknown:
        warnings.warn(f"ignoring unknown model.arch keys: {unknown}")
    return dataclasses.replace(base, **{k: v for k, v in block.items() if k in known})


@dataclass(frozen=True)
class YoloConfig:
    """Mirrors config/yolo_config.yaml. ``device`` is read and kept so that one
    YAML serves both packages; the port's detector runs on the device its
    caller names (``"cuda"`` by default), whatever this field says."""

    name: str = "yolov8s"
    weights_path: str = "models/yolo/yolov8s.pt"
    device: str = "tpu"
    imgsz: int = 640
    conf_threshold: float = 0.25
    iou_threshold: float = 0.45
    max_det: int = 5
    classes: Optional[Sequence[int]] = None
    agnostic_nms: bool = False
    # minimum box area as a fraction of the image; 0 crops every detection,
    # as the reference does. The committed synthetic-corpus detector can fire
    # confident near-zero-area boxes on real photos; ~0.01 drops those.
    min_box_frac: float = 0.0
    crop_enabled: bool = False
    crop_save_dir: str = "data/cropped"
    filename_pattern: str = "{stem}_crop_{idx}.jpg"


def load_yolo_config(path: Optional[str] = None) -> YoloConfig:
    """Parse the config/yolo_config.yaml shape; a missing path gives defaults."""
    if path is None or not os.path.exists(path):
        return YoloConfig()
    raw = _read_yaml(path)
    model = raw.get("model", {}) or {}
    inf = raw.get("inference", {}) or {}
    crop = raw.get("crop", {}) or {}
    return YoloConfig(
        name=model.get("name", "yolov8s"),
        weights_path=model.get("weights_path", "models/yolo/yolov8s.pt"),
        device=model.get("device", "tpu"),
        imgsz=model.get("imgsz", 640),
        conf_threshold=inf.get("conf_threshold", 0.25),
        iou_threshold=inf.get("iou_threshold", 0.45),
        max_det=inf.get("max_det", 5),
        classes=inf.get("classes"),
        agnostic_nms=inf.get("agnostic_nms", False),
        crop_enabled=crop.get("enabled", False),
        crop_save_dir=crop.get("save_dir", "data/cropped"),
        filename_pattern=crop.get("filename_pattern", "{stem}_crop_{idx}.jpg"),
    )


@dataclass(frozen=True)
class DBConfig:
    """Mirrors config/db_config.yaml (a ``postgres:`` block or flat keys)."""

    host: str = "localhost"
    port: int = 5432
    user: str = "postgres"
    password: str = ""
    dbname: str = "balikkin_db"

    @property
    def url(self) -> str:
        return (
            f"postgresql://{self.user}:{self.password}"
            f"@{self.host}:{self.port}/{self.dbname}"
        )


def load_db_config(path: Optional[str] = None) -> DBConfig:
    """Parse config/db_config.yaml; a ``postgres:`` block or flat keys."""
    if path is None or not os.path.exists(path):
        return DBConfig()
    raw = _read_yaml(path)
    block = raw.get("postgres", raw) or {}
    names = {f.name for f in dataclasses.fields(DBConfig)}
    return DBConfig(**{k: v for k, v in block.items() if k in names})


@dataclass(frozen=True)
class EvalConfig:
    """Mirrors config/evaluation_config.yaml's ``paths:``, ``models:`` and
    ``evaluation:`` blocks."""

    train_csv: str = "data/text/train_fashion.csv"
    val_csv: str = "data/text/val_fashion.csv"
    test_csv: str = "data/text/val_fashion.csv"
    image_root: str = "data/text/images"
    lora_dir: str = "models/saved/clip-lora"
    results_dir: str = "results"
    plots_dir: str = "results/plots"
    qualitative_dir: str = "results/qualitative"
    lora_epochs: Sequence[int] = (1,)
    best_epoch: int = 1
    recall_k_values: Sequence[int] = (1, 5, 10)
    num_failure_cases: int = 10
    num_top_k_visualize: int = 5
    embedding_viz_method: str = "tsne"
    skip_base: bool = False
    skip_qualitative: bool = False
    # the threshold-relevance protocol's constant (ref:scripts/evaluate.py:24)
    relevance_threshold: float = 0.7


def load_eval_config(path: Optional[str] = None) -> EvalConfig:
    """Parse the config/evaluation_config.yaml shape; a missing path gives
    defaults."""
    if path is None or not os.path.exists(path):
        return EvalConfig()
    raw = _read_yaml(path)
    paths = raw.get("paths", {}) or {}
    models = raw.get("models", {}) or {}
    ev = raw.get("evaluation", {}) or {}
    d = EvalConfig()
    return EvalConfig(
        train_csv=paths.get("train_csv", d.train_csv),
        val_csv=paths.get("val_csv", d.val_csv),
        test_csv=paths.get("test_csv", d.test_csv),
        image_root=paths.get("image_root", d.image_root),
        lora_dir=paths.get("lora_dir", d.lora_dir),
        results_dir=paths.get("results_dir", d.results_dir),
        plots_dir=paths.get("plots_dir", d.plots_dir),
        qualitative_dir=paths.get("qualitative_dir", d.qualitative_dir),
        lora_epochs=tuple(models.get("lora_epochs", d.lora_epochs)),
        best_epoch=models.get("best_epoch", d.best_epoch),
        recall_k_values=tuple(ev.get("recall_k_values", d.recall_k_values)),
        num_failure_cases=ev.get("num_failure_cases", d.num_failure_cases),
        num_top_k_visualize=ev.get("num_top_k_visualize", d.num_top_k_visualize),
        embedding_viz_method=ev.get("embedding_viz_method", d.embedding_viz_method),
        skip_base=ev.get("skip_base", d.skip_base),
        skip_qualitative=ev.get("skip_qualitative", d.skip_qualitative),
    )


def to_dict(cfg: Any) -> dict:
    """Dataclass → plain dict (for JSON artifacts and checkpoint metadata)."""
    return dataclasses.asdict(cfg)
