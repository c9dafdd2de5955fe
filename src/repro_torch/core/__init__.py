from repro_torch.core.hostcall import HostCallTable
from repro_torch.core.syscore import (ProgramHandle, ProgramSpec, Syscore,
                                      UnknownProgramError)

__all__ = ["HostCallTable", "ProgramHandle", "ProgramSpec", "Syscore",
           "UnknownProgramError"]
