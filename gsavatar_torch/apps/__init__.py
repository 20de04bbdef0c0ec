"""The serving apps: an avatar from a checkpoint and an SMPL npz
(`InferenceScene.from_smpl_npz`), driven by a motion series
(`motion.MotionSeries`), rendered frame by frame on the device:

- `render_series`: motion playback under orbiting cameras, PNG frames;
- `body_replace`: the avatar composited over the frames of a video;
- `ar_render`: the avatar over a webcam feed, placed by an ArUco board;
- `capture_and_record`: a ZJU-MoCap tree (JPEG frames, PNG masks, SMPL
  npz files, cam_params.json) that the training path reads back.

Only the video files, the webcam, the board's detection and the on-screen
display need OpenCV (`motion/streams.py`)."""
