from fantoch_tpu_torch.sim.faults import FaultPlan, Nemesis
from fantoch_tpu_torch.sim.runner import Runner
from fantoch_tpu_torch.sim.schedule import Schedule
from fantoch_tpu_torch.sim.simulation import Simulation
