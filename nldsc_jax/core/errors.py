class NLDSCError(Exception):
    """Base error for the nldsc-jax framework."""


class NLDSCParameterError(NLDSCError):
    """Invalid user-supplied parameter.

    Mirrors the validation contract of the reference
    (``nldsc/core/common.py:23-24``) so CLI behavior matches.
    """


class NLDSCDataError(NLDSCError):
    """Malformed input data (bad magic number, unsorted positions, ...)."""
