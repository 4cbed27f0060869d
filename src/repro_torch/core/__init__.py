"""REFT core: the paper's contribution (in-memory fault tolerance).

Import the modules directly (`repro_torch.core.coordinator`, ...): this
`__init__` stays empty so the numpy-only SMP processes, which import
`repro_torch.core.smp`, never load torch.
"""
