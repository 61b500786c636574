from fantoch_tpu_torch.client.client import Client
from fantoch_tpu_torch.client.data import ClientData
from fantoch_tpu_torch.client.key_gen import CONFLICT_COLOR, ConflictRateKeyGen, KeyGen, KeyGenState, ZipfKeyGen
from fantoch_tpu_torch.client.pending import Pending
from fantoch_tpu_torch.client.workload import Workload
