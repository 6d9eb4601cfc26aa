from .tables import make_tau_table
from .blackbody import BlackBodySource

__all__ = ["make_tau_table", "BlackBodySource"]
