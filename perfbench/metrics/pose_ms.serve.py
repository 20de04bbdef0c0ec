"""The harness's span around `MotionSeries.camera_pose_fields` and
`live_camera`, host ms a frame."""


def read(tr):
    return tr.per_unit_ms('bench/pose')
