"""Signal and physical constants for supported GNSS signals.

Mirrors the per-system constant headers of the reference
(``src/core/system_parameters/GPS_L1_CA.h`` etc.) with only the values the
receiver chain needs.  All values are public ICD constants.
"""

# --- physical ---------------------------------------------------------------
SPEED_OF_LIGHT_M_S = 299_792_458.0
GPS_GM = 3.986005e14          # WGS-84 earth gravitational constant [m^3/s^2]
GPS_OMEGA_EARTH_DOT = 7.2921151467e-5  # WGS-84 earth rotation rate [rad/s]
GPS_F_RELATIVISTIC = -4.442807633e-10  # relativistic clock factor [s/m^0.5]
GALILEO_GM = 3.986004418e14   # GTRF earth gravitational constant [m^3/s^2]

# --- GPS L1 C/A (reference: src/core/system_parameters/GPS_L1_CA.h) ---------
GPS_L1_FREQ_HZ = 1_575.42e6
GPS_L1_CA_CODE_RATE_CPS = 1.023e6
GPS_L1_CA_CODE_LENGTH_CHIPS = 1023
GPS_L1_CA_CODE_PERIOD_S = GPS_L1_CA_CODE_LENGTH_CHIPS / GPS_L1_CA_CODE_RATE_CPS
GPS_L1_CA_CODE_PERIOD_MS = 1.0
GPS_L1_CA_CHIPS_PER_SYMBOL = 1023
GPS_L1_CA_BIT_RATE_BPS = 50
GPS_L1_CA_CODES_PER_BIT = 20
GPS_L1_CA_PREAMBLE_BITS = (1, 0, 0, 0, 1, 0, 1, 1)
GPS_L1_CA_OPT_ACQ_FS_SPS = 2_000_000  # GPS_L1_CA.h:53 acquisition-optimal fs

# --- GPS L2C / L5 -----------------------------------------------------------
GPS_L2_FREQ_HZ = 1_227.60e6
GPS_L2C_M_CODE_RATE_CPS = 0.5115e6
GPS_L2C_M_CODE_LENGTH_CHIPS = 10230
GPS_L5_FREQ_HZ = 1_176.45e6
GPS_L5_CODE_RATE_CPS = 10.23e6
GPS_L5_CODE_LENGTH_CHIPS = 10230
GPS_L5I_NH_CODE = (0, 0, 0, 0, 1, 1, 0, 1, 0, 1)       # 10-bit Neuman-Hofman
GPS_L5Q_NH_CODE = (0, 0, 0, 0, 0, 1, 0, 0, 1, 1,
                   0, 1, 0, 1, 0, 1, 1, 1, 0, 0)       # 20-bit Neuman-Hofman

# --- Galileo E1 -------------------------------------------------------------
GALILEO_E1_FREQ_HZ = 1_575.42e6
GALILEO_E1_CODE_RATE_CPS = 1.023e6
GALILEO_E1_B_CODE_LENGTH_CHIPS = 4092
GALILEO_E1_CODE_PERIOD_S = 4e-3
GALILEO_E1_C_SECONDARY_CODE = (
    0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1)

# --- Galileo E5a ------------------------------------------------------------
GALILEO_E5A_FREQ_HZ = 1_176.45e6
GALILEO_E5A_CODE_RATE_CPS = 10.23e6
GALILEO_E5A_CODE_LENGTH_CHIPS = 10230

# --- Galileo E6 (B/C, HAS) ---------------------------------------------------
# reference: Galileo_E6.h:30-45 (E6-B/C Codes Technical Note Issue 1, 2019)
GALILEO_E6_FREQ_HZ = 1_278.75e6
GALILEO_E6_CODE_RATE_CPS = 5.115e6
GALILEO_E6_CODE_LENGTH_CHIPS = 5115

# --- Galileo E5b ------------------------------------------------------------
GALILEO_E5B_FREQ_HZ = 1_207.14e6
GALILEO_E5B_CODE_RATE_CPS = 10.23e6
GALILEO_E5B_CODE_LENGTH_CHIPS = 10230
# E5b-I secondary code CS4 (same for all SVs, ICD table 37: '1110')
GALILEO_E5B_I_SECONDARY_CODE = (1, 1, 1, 0)

# --- GLONASS L1 (FDMA) ------------------------------------------------------
GLONASS_L1_FREQ_HZ = 1_602.0e6
GLONASS_L1_DFREQ_HZ = 0.5625e6   # frequency-slot spacing (DFRQ1_GLO)
GLONASS_L2_FREQ_HZ = 1_246.0e6
GLONASS_L2_DFREQ_HZ = 0.4375e6   # L2 slot spacing (DFRQ2_GLO)
GLONASS_CA_CODE_RATE_CPS = 0.511e6
GLONASS_CA_CODE_LENGTH_CHIPS = 511
# orbital-slot PRN -> frequency-channel number k (public GLONASS almanac
# assignment; reference table GLONASS_L1_L2_CA.h:134 GLONASS_PRN)
GLONASS_PRN_SLOT = {
    1: 1, 2: -4, 3: 5, 4: 6, 5: 1, 6: -4, 7: 5, 8: 6,
    9: -2, 10: -7, 11: 0, 12: -1, 13: -2, 14: -7, 15: 0, 16: -1,
    17: 4, 18: -3, 19: 3, 20: -5, 21: 4, 22: -3, 23: 3, 24: 2,
}

# --- BeiDou B1I -------------------------------------------------------------
BEIDOU_B1I_FREQ_HZ = 1_561.098e6
BEIDOU_B1I_CODE_RATE_CPS = 2.046e6
BEIDOU_B1I_CODE_LENGTH_CHIPS = 2046

# --- BeiDou B3I -------------------------------------------------------------
BEIDOU_B3I_FREQ_HZ = 1_268.52e6
BEIDOU_B3I_CODE_RATE_CPS = 10.23e6
BEIDOU_B3I_CODE_LENGTH_CHIPS = 10230

# --- GPS time ---------------------------------------------------------------
GPS_WEEK_SECONDS = 604_800
GPS_TOW_MAX_MS = 604_800_000
