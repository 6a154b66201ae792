"""PX4 uORB message definitions for rosbag2 deserialization.

Counterpart of ``bluerov2_dynamics_tpu/data/px4_msgs.py``: the public PX4
interface definitions (field layout only; it must match the recorded bags
byte for byte).  :mod:`.typesys` preloads them, and
:func:`register_px4_types` registers them with a ``rosbags`` typestore
(``rosbags`` is imported only inside it).
"""

ACTUATOR_MOTORS = """\
uint32 MESSAGE_VERSION = 0
uint64 timestamp
uint64 timestamp_sample
uint16 reversible_flags
uint8 ACTUATOR_FUNCTION_MOTOR1 = 101
uint8 NUM_CONTROLS = 12
float32[12] control
"""

VEHICLE_ODOMETRY = """\
uint32 MESSAGE_VERSION = 0
uint64 timestamp
uint64 timestamp_sample
uint8 pose_frame
uint8 POSE_FRAME_UNKNOWN = 0
uint8 POSE_FRAME_NED = 1
uint8 POSE_FRAME_FRD = 2
float32[3] position
float32[4] q
uint8 velocity_frame
uint8 VELOCITY_FRAME_UNKNOWN = 0
uint8 VELOCITY_FRAME_NED = 1
uint8 VELOCITY_FRAME_FRD = 2
uint8 VELOCITY_FRAME_BODY_FRD = 3
float32[3] velocity
float32[3] angular_velocity
float32[3] position_variance
float32[3] orientation_variance
float32[3] velocity_variance
uint8 reset_counter
int8 quality
"""

SENSOR_COMBINED = """\
uint64 timestamp
int32 RELATIVE_TIMESTAMP_INVALID = 2147483647
float32[3] gyro_rad
uint32 gyro_integral_dt
int32 accelerometer_timestamp_relative
float32[3] accelerometer_m_s2
uint32 accelerometer_integral_dt
uint8 CLIPPING_X = 1
uint8 CLIPPING_Y = 2
uint8 CLIPPING_Z = 4
uint8 accelerometer_clipping
uint8 gyro_clipping
uint8 accel_calibration_count
uint8 gyro_calibration_count
"""

MANUAL_CONTROL_SETPOINT = """\
uint32 MESSAGE_VERSION = 0
uint64 timestamp
uint64 timestamp_sample
bool valid
uint8 SOURCE_UNKNOWN = 0
uint8 SOURCE_RC = 1
uint8 data_source
float32 roll
float32 pitch
float32 yaw
float32 throttle
float32 flaps
float32 aux1
float32 aux2
float32 aux3
float32 aux4
float32 aux5
float32 aux6
bool sticks_moving
uint16 buttons
"""

DEFINITIONS = {
    "px4_msgs/msg/ActuatorMotors": ACTUATOR_MOTORS,
    "px4_msgs/msg/VehicleOdometry": VEHICLE_ODOMETRY,
    "px4_msgs/msg/SensorCombined": SENSOR_COMBINED,
    "px4_msgs/msg/ManualControlSetpoint": MANUAL_CONTROL_SETPOINT,
}


def register_px4_types(typestore) -> None:
    """Register the PX4 definitions with a ``rosbags`` typestore."""
    from rosbags.typesys import get_types_from_msg

    from bluerov2_dynamics_tpu_torch.utils.log import info, warn

    registered = []
    for typename, text in DEFINITIONS.items():
        try:
            typestore.register(get_types_from_msg(text, typename))
            registered.append(typename)
        except Exception as e:  # pragma: no cover
            warn(f"Could not register {typename}: {e}")
    if registered:
        info("Registered custom types:", ", ".join(sorted(registered)))
