"""Scale-out over ``torch.distributed`` (counterpart of cppf_tpu/parallel/):
pair-sharded voting and pose (``mesh.py``, ``pose.py``), the data-parallel
train step (``train_step.py``) and the per-process input shard
(``input_pipeline.py``)."""
