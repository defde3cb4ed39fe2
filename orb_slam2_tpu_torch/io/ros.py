"""ROS node adapters: live-topic frontends for the SLAM session (port of
orb_slam2_tpu/io/ros.py).

Mirrors the reference's ROS nodes (Examples/ROS/ORB_SLAM2/src/):

  * `MonoNode`   — ros_mono.cc: subscribe /camera/image_raw, track_mono
  * `StereoNode` — ros_stereo.cc: synchronized left/right pair, optional
                   rectification maps (remapped with
                   `io/datasets.remap_bilinear`, no OpenCV)
  * `RGBDNode`   — ros_rgbd.cc: ApproximateTime-synced rgb + depth
  * AR demo      — ros_mono_ar.cc / ViewerAR.cc: see `viz/ar.py`

rospy, cv_bridge, message_filters and sensor_msgs are imported lazily, so
the module imports (and its conversion cores are testable) where ROS is
absent.  `_to_gray` and `_to_depth` take plain numpy arrays and replicate
the cv_bridge + RGB/BGR handling of the reference (ros_mono.cc:58-68,
ros_rgbd.cc:76-84).

    python -m orb_slam2_tpu_torch.io.ros <mono|stereo|rgbd> settings.yaml [--device cuda]
"""

from __future__ import annotations

import numpy as np

from orb_slam2_tpu_torch.io.datasets import remap_bilinear


def _to_gray(img: np.ndarray, rgb: bool = True) -> np.ndarray:
    """Any uint8 mono/3-channel image -> float32 grayscale (the reference
    converts with cvtColor RGB2GRAY or BGR2GRAY per Camera.RGB,
    Tracking.cc:172-197): float32 samples times float64 weights, cast to
    float32."""
    img = np.asarray(img)
    if img.ndim == 2:
        return img.astype(np.float32)
    w = (np.array([0.299, 0.587, 0.114]) if rgb
         else np.array([0.114, 0.587, 0.299]))
    return (img[..., :3].astype(np.float32) @ w).astype(np.float32)


def _to_depth(depth: np.ndarray, factor: float) -> np.ndarray:
    """Depth message payload -> metric float32 depth (the reference applies
    mDepthMapFactor unless already float, Tracking.cc:243-249)."""
    depth = np.asarray(depth)
    if depth.dtype in (np.float32, np.float64):
        return depth.astype(np.float32)
    return depth.astype(np.float32) / float(factor)


class _NodeBase:
    def __init__(self, slam, rgb: bool = True):
        self.slam = slam
        self.rgb = rgb

    def _stamp(self, msg) -> float:
        return msg.header.stamp.to_sec()

    def spin(self):
        import rospy
        rospy.spin()
        self.slam.flush()


class MonoNode(_NodeBase):
    """ros_mono.cc equivalent: one image topic -> track_mono."""

    def __init__(self, slam, topic: str = "/camera/image_raw",
                 rgb: bool = True):
        super().__init__(slam, rgb)
        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image
        self._bridge = CvBridge()
        self._sub = rospy.Subscriber(topic, Image, self.callback,
                                     queue_size=1)

    def callback(self, msg):
        img = self._bridge.imgmsg_to_cv2(msg)
        self.slam.track_mono(_to_gray(img, self.rgb), self._stamp(msg))


class StereoNode(_NodeBase):
    """ros_stereo.cc equivalent: synchronized left/right image topics;
    `rectify` = (m1x, m1y, m2x, m2y) float maps or None."""

    def __init__(self, slam, left: str = "/camera/left/image_raw",
                 right: str = "/camera/right/image_raw", rgb: bool = True,
                 rectify=None, queue: int = 10):
        super().__init__(slam, rgb)
        import message_filters
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image
        self._bridge = CvBridge()
        self.rectify = rectify
        subs = [message_filters.Subscriber(left, Image),
                message_filters.Subscriber(right, Image)]
        self._sync = message_filters.ApproximateTimeSynchronizer(
            subs, queue, 0.1)
        self._sync.registerCallback(self.callback)

    def callback(self, ml, mr):
        l = _to_gray(self._bridge.imgmsg_to_cv2(ml), self.rgb)
        r = _to_gray(self._bridge.imgmsg_to_cv2(mr), self.rgb)
        if self.rectify is not None:
            m1x, m1y, m2x, m2y = self.rectify
            l = remap_bilinear(l, m1x, m1y)
            r = remap_bilinear(r, m2x, m2y)
        self.slam.track_stereo(l, r, self._stamp(ml))


class RGBDNode(_NodeBase):
    """ros_rgbd.cc equivalent: ApproximateTime-synced rgb + depth topics
    (ros_rgbd.cc:76-84)."""

    def __init__(self, slam, rgb_topic: str = "/camera/rgb/image_raw",
                 depth_topic: str = "/camera/depth_registered/image_raw",
                 rgb: bool = True, queue: int = 10):
        super().__init__(slam, rgb)
        import message_filters
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image
        self._bridge = CvBridge()
        subs = [message_filters.Subscriber(rgb_topic, Image),
                message_filters.Subscriber(depth_topic, Image)]
        self._sync = message_filters.ApproximateTimeSynchronizer(
            subs, queue, 0.1)
        self._sync.registerCallback(self.callback)

    def callback(self, mrgb, mdepth):
        img = _to_gray(self._bridge.imgmsg_to_cv2(mrgb), self.rgb)
        depth = _to_depth(self._bridge.imgmsg_to_cv2(mdepth),
                          self.slam.cfg.camera.depth_map_factor)
        self.slam.track_rgbd(img, depth, self._stamp(mrgb))


def main(argv=None):
    """`python -m orb_slam2_tpu_torch.io.ros <mono|stereo|rgbd>
    settings.yaml [--device D]` — the CLI shape of the reference nodes
    (ros_mono.cc:40-55); the session runs on the CUDA card unless
    `--device` names another device."""
    import argparse

    from orb_slam2_tpu_torch import config as cfg_mod
    from orb_slam2_tpu_torch.io.settings import load_settings
    from orb_slam2_tpu_torch.pipeline.system import SLAM

    ap = argparse.ArgumentParser(prog="orb_slam2_tpu_torch.io.ros")
    ap.add_argument("sensor", choices=["mono", "stereo", "rgbd"])
    ap.add_argument("settings")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    sensor = dict(mono=cfg_mod.MONOCULAR, stereo=cfg_mod.STEREO,
                  rgbd=cfg_mod.RGBD)[args.sensor]
    slam = SLAM(load_settings(args.settings, sensor), device=args.device)

    import rospy
    rospy.init_node(f"orb_slam2_tpu_torch_{args.sensor}")
    node = {"mono": MonoNode, "stereo": StereoNode,
            "rgbd": RGBDNode}[args.sensor](slam)
    node.spin()
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")


if __name__ == "__main__":
    main()
