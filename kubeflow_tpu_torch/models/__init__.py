"""The port's model library — counterpart of ``kubeflow_tpu/models``.

GPT and the BERT models train under a context axis with
``attention="ring"|"ulysses"``. The pipeline-parallel models
(``GPTPipelineLM``, ``BertPipelineClassifier``) come with the pipeline
axis (ROADMAP Queue A item 8).
"""

from kubeflow_tpu_torch.models.bert import (
    BertConfig,
    BertEncoder,
    BertForMaskedLM,
    BertForSequenceClassification,
)
from kubeflow_tpu_torch.models.gpt import (
    GPTConfig,
    GPTLM,
    causal_lm_eval_metrics,
    causal_lm_loss,
)
from kubeflow_tpu_torch.models.mnist import MnistCNN, MnistMLP
from kubeflow_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    s2d_pack,
    stem_weights_7x7_to_s2d,
)
from kubeflow_tpu_torch.models.vit import ViTClassifier, ViTConfig

__all__ = [
    "BertConfig",
    "BertEncoder",
    "BertForMaskedLM",
    "BertForSequenceClassification",
    "GPTConfig",
    "GPTLM",
    "causal_lm_loss",
    "causal_lm_eval_metrics",
    "MnistMLP",
    "MnistCNN",
    "ViTClassifier",
    "ViTConfig",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "s2d_pack",
    "stem_weights_7x7_to_s2d",
]
