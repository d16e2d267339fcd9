from . import fast_vmae, layers, raft, vmae  # noqa: F401
