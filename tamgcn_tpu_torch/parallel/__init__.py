"""The parallel layer of the port over torch.distributed: the (data, model)
grid of ranks (mesh.py), its collectives (comm.py), the joint ring
(graph_parallel.py), the tensor-parallel rules and the step's gradient
reduction (sharded.py), the time-sharded CTR-GCN (sequence.py) and a
launcher of ranks on one host (launch.py). Counterpart of
tamgcn_tpu/parallel/."""
