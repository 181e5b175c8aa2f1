"""Distribution layer of the port, over ``torch.distributed``: the
partitioning plans (``plan.py``: ``ParallelPlan`` / ``make_plan`` and the
tensor-parallel paged serve plan with its pool pricing), the TP marks,
the serving marks and the counted collectives with their autograd forms
(``hints.py``), the ``train`` plan executed (``train.py``), the serving
plans executed by the static engine (``serve.py``), cross-pod int8
gradient compression (``compression.py``) and the ring collective
matmuls (``collective_matmul.py``)."""
