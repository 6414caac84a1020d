"""The pseudo-label factory: PWCLite optical flow, flow-to-box mining with
DP smoothing, SiamFC crops and the training loader's `train.json`
(counterpart of `usot_tpu/preprocessing/`)."""
