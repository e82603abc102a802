"""sage_icp_tpu — an accelerator-native semantic LiDAR odometry framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of SAGE-ICP
(NeSC-IV/sage-icp, ICRA 2024): motion-compensated deskewing, class-adaptive
voxel downsampling, a fixed-capacity semantic voxel-hash local map,
semantically weighted point-to-point ICP with a KISS-ICP adaptive threshold,
KITTI/KITTI-360 dataset readers and KITTI-dev-kit metrics — all expressed as
fixed-shape, masked, functional array programs that jit/shard onto GPU
device meshes.

The reference system is CPU-only C++/TBB driven by ROS2; this framework is
*not* a port: every per-point loop is a vectorized XLA program, the voxel
hash map is an open-addressing table in device arrays, and the 6x6
Gauss-Newton system reduces through a fused Pallas kernel (or f32
matmuls) and, under sharding, psum collectives.
"""

__version__ = "0.1.0"
