from mind_tpu_torch.sim.agents import NonReactiveAgent, CustomizedAgent, MINDAgent
from mind_tpu_torch.sim.simulator import Simulator
