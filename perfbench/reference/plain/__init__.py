"""A frozen copy of the plain path of gsavatar_torch (the modules that one
playback frame and one training step of the benchmark's two
configurations run), with every kernel replaced by its plain version on
every device: the plain reference that decides `correct`."""
