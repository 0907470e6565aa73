"""Training — counterpart of ``kubeflow_tpu/train``: the Trainer, its
checkpoints, data pipeline and metric lines."""
