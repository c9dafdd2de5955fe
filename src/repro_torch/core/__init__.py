from repro_torch.core.hostcall import HostCallTable
from repro_torch.core.program_store import ProgramSpec, ProgramStore
from repro_torch.core.syscore import (ProgramHandle, Syscore,
                                      UnknownProgramError, cold_execute)

__all__ = ["HostCallTable", "ProgramHandle", "ProgramSpec", "ProgramStore",
           "Syscore", "UnknownProgramError", "cold_execute"]
