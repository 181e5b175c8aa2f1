"""Distribution layer of the port: the tensor-parallel paged serve plan
and its pool pricing (``plan.py``), the TP marks and counted collectives
(``hints.py``) and the ring collective matmuls (``collective_matmul.py``),
over ``torch.distributed``.  Cross-pod gradient compression and the GSPMD
training plans wait (ROADMAP Queue 1, 'Parallel training and the dry-run's
meshes')."""
