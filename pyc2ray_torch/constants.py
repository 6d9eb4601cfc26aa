"""Physical constants (CGS) used throughout the PyTorch port of pyc2ray.

The values mirror the hard-coded C2Ray-compatible constants of the reference
implementation (reference: pyc2ray/c2ray_base.py:74-80 and
pyc2ray/radiation/blackbody.py:10-16) so that results are directly comparable
with the original code. Where the reference falls back to astropy values we
use the CODATA/IAU numbers astropy ships.
"""

# --- C2Ray-compatible conversion factors (c2ray_base.py:74-80) ---
pc = 3.086e18                 # parsec in cm (C2Ray value)
kpc = 1e3 * pc                # kiloparsec in cm
Mpc = 1e6 * pc                # megaparsec in cm
YEAR = 3.15576e7              # year in seconds (C2Ray value)
ev2fr = 0.241838e15           # eV -> frequency (Hz)
ev2k = 1.0 / 8.617e-05        # eV -> Kelvin
msun2g = 1.98892e33           # solar mass in grams (C2Ray value)

# --- Radiation/table constants (blackbody.py:10-16) ---
h_over_k = 6.6260755e-27 / 1.381e-16   # Planck constant over Boltzmann (cgs)
pi_c2ray = 3.141592654                 # truncated pi used by C2Ray SED prefactor
c_light = 2.997925e10                  # speed of light, C2Ray-truncated value (cm/s)
two_pi_over_c_square = 2.0 * pi_c2ray / (c_light * c_light)
hplanck = 6.62607015e-34 * 1e7         # Planck constant, SI 2018 exact, in erg s
# Rydberg frequency = (Ryd * c) in Hz; astropy cgs value
ion_freq_HI = 3.2898419602500e15
sigma_0 = 6.3e-18                      # reference HI cross section at nu_HI (cm^2)

# --- Raytracing / rates constants (photorates.f90:7, rates.cu:7-8,
#     raytracing.f90:368, raytracing.cu:15) ---
S_STAR_REF = 1.0e48           # reference source strength (photons/s)
TAU_PHOTO_LIMIT = 1.0e-7      # thin/thick optical-depth switch
MAX_COLDENSH = 2.0e30         # column density above which rates are zeroed
EPSILON = 1.0e-14             # floor for ionized fractions (chemistry.f90:8)

# --- Cosmology (standard values; the reference delegates these to astropy) ---
G_GRAV = 6.6743e-8            # gravitational constant, cgs
C_EXACT = 2.99792458e10       # exact speed of light, cm/s
A_RAD = 7.565723e-15          # radiation constant a = 4 sigma_SB / c, erg cm^-3 K^-4
KM = 1e5                      # km in cm
