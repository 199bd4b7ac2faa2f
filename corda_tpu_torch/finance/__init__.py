"""Finance states and commands (counterpart of corda_tpu/finance): only what
the notary slice's Cash moves carry."""

from .contracts import CASH_PROGRAM_ID, CashState, Issue, Move

__all__ = ["CASH_PROGRAM_ID", "CashState", "Issue", "Move"]
