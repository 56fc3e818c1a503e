"""End-to-end parity harness (port of mind_tpu/parity): a host-numpy,
float64, reference-control-flow re-implementation of the full MIND plan
cycle (process_data -> branch_aime -> warm+full tree-iLQR -> selection),
run against the port's device path to hold it to the 1e-3 trajectory-parity
north star (BASELINE.json).

The reference itself (torch+theano+av2) is not run here and its checkpoints
are stripped, so parity is established with shared weights, shared scenario
data and an independent host mirror that follows the reference's control
flow (reference planner.py:104-145, scenario_tree.py:38-108,
solver.py:80-240), while both sides run the same prediction network.
"""

from mind_tpu_torch.parity.host_planner import HostRefPlanner
