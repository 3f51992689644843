"""Vector similarity calibration with the likelihood-ratio framework
(extension example: VPT + density priors)."""

import numpy as np

from bayesian_bm25_tpu import (
    VectorProbabilityTransform,
    ivf_density_prior,
)

rng = np.random.default_rng(0)

# Corpus distance distribution (background) and a query's neighborhood with
# a clear semantic cliff: 12 close matches, then background.
background = rng.normal(0.62, 0.1, 5000)
vpt = VectorProbabilityTransform.fit_background(background, base_rate=0.05)
print(f"background: mu_G={vpt.mu_G:.3f} sigma_G={vpt.sigma_G:.3f}")

neighborhood = np.concatenate([
    rng.normal(0.18, 0.02, 12),   # relevant cluster
    rng.normal(0.60, 0.08, 88),   # background shell
])
probs = vpt.calibrate(neighborhood)
order = np.argsort(neighborhood)
print("\nclosest five distances -> probabilities:")
for i in order[:5]:
    print(f"  d={neighborhood[i]:.3f} -> P={probs[i]:.4f}")
print("background shell sample:")
for i in order[-3:]:
    print(f"  d={neighborhood[i]:.3f} -> P={probs[i]:.6f}")

gap = vpt._detect_gap(neighborhood)
print(f"\ngap detected after sorted index: {gap} (12 relevant docs)")

print("\nIVF density prior (sparse cells -> higher weight, IDF analogue):")
for pop in (5, 50, 500):
    print(f"  cell population {pop:>4} vs avg 50 -> "
          f"prior {ivf_density_prior(pop, 50.0):.3f}")
