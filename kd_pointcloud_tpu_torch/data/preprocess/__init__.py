"""Offline preprocessors of the port: raw FlyingThings3D-subset and KITTI
Scene Flow frames -> the pc1.npy / pc2.npy scene trees the datasets read
(kd_pointcloud_tpu/data/preprocess, copied). numpy and the standard
library only; PIL only for image formats the bundled PNG codec lacks.

    python -m kd_pointcloud_tpu_torch.data.preprocess.ft3d \\
        --raw_data_path RAW --save_path OUT [--only_save_near_pts]
    python -m kd_pointcloud_tpu_torch.data.preprocess.kitti RAW OUT \\
        --calib_root DIR
"""
