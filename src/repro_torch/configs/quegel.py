"""The paper's own workload config: graph-engine defaults (not an LM)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class QuegelConfig:
    capacity: int = 8          # the paper's C (saturates ~8 on their GbE)
    backend: str = "coo"       # coo | blocks_ref | cuda
    block_size: int = 128      # tile edge of the block-sparse layout
    hub_k: int = 1000          # Hub^2 hubs (paper: 100/1000)
    partition: str = "dst"     # distributed combine scheme
