"""The paper's own workload configuration (benchmark Sec 6): store capacity
and batch geometry for the Fig. 8 / Fig. 9 reproductions, over the port's
:class:`repro_torch.api.UruvConfig` (the JAX package's fields and
defaults)."""
import dataclasses

from repro_torch.api import UruvConfig


@dataclasses.dataclass(frozen=True)
class UruvWorkload:
    store: UruvConfig = UruvConfig(
        leaf_cap=64, max_leaves=1 << 14, max_versions=1 << 20, max_chain=64
    )
    key_universe: int = 500_000_000   # paper: keys drawn from [1, 500M]
    prefill: int = 1_000_000          # scaled from the paper's 100M
    batch: int = 4096                 # announce-array width
    range_size: int = 1000            # paper: 1K range queries


def config() -> UruvWorkload:
    return UruvWorkload()
