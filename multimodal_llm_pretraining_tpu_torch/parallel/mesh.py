"""Topology request (counterpart of ``parallel/mesh.py``).

Only the ``MeshConfig`` dataclass is ported: the port runs on one host with
one GPU. Multi-GPU meshes (``torch.distributed`` device meshes, FSDP) are
ROADMAP Queue 1 item 7.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshConfig:
    num_hosts: int = 1
    chips_per_host: int = 1
    hybrid: bool = False
    tensor_parallel: int = 1

    @property
    def num_devices(self) -> int:
        return self.num_hosts * self.chips_per_host

    def require_single_device(self) -> None:
        if self.num_devices != 1 or self.tensor_parallel != 1 or self.hybrid:
            raise NotImplementedError(
                f"{self} asks for more than one GPU; multi-GPU meshes are ROADMAP Queue 1 item 7"
            )
