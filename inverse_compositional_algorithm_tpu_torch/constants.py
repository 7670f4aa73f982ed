"""Algorithm constants.

Parity notes: values mirror the reference implementation's fixed constants
(reference: src/constants.py:1-6) which themselves come from the IPOL
"(Modified) Inverse Compositional Algorithm" articles (2016.153 / 2018.222).
"""

# Maximum Gauss-Newton iterations per scale (reference: src/constants.py:1).
MAX_ITER = 30

# Lambda-annealing (continuation) schedule for robust IRLS when the user
# passes lambda <= 0 (reference: src/constants.py:2-4, applied at
# src/inverse_compositional_algorithm.py:223,235-238).
LAMBDA_0 = 80.0
LAMBDA_N = 5.0
LAMBDA_RATIO = 0.9

# Gaussian presmoothing scale for the IPOL pyramid downsample:
# sigma = ZOOM_SIGMA_ZERO * sqrt(1/nu^2 - 1)  (reference: src/zoom.py:45,
# src/constants.py:6).
ZOOM_SIGMA_ZERO = 0.6

# Number of parameter slots every transform is padded to. 8 is the size of
# the largest model (homography). The padded representation lets all five
# motion models share one fixed [B, 8] state and one solver loop (the
# reference proves the trick works at src/keras-tf/tf_transformation.py:28-35).
NPARAMS_MAX = 8
