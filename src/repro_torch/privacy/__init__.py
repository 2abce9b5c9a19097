"""Privacy substrate: RDP accounting, composition, block ledgers."""
from .rdp import (DEFAULT_ORDERS, gaussian_rdp, rdp_to_dp, sigma_for_rdp_budget,
                  subsampled_gaussian_rdp)
from .accountant import RdpAccountant
from .ledger import BlockLedger, BlockState

__all__ = [
    "DEFAULT_ORDERS", "gaussian_rdp", "rdp_to_dp", "sigma_for_rdp_budget",
    "subsampled_gaussian_rdp", "RdpAccountant", "BlockLedger", "BlockState",
]
