function [theta_rot, phi_rot] = rotate_angles(rotation_deg, el_deg, az_deg)
% ROTATE_ANGLES  Euler rotation of spherical angles; degrees in, radians out.
%
% Same closed form as deepmimo_tpu/ops/geometry.py (validated against
% tests/oracle.py:oracle_rotate): rotate the global (el, az) direction
% into the panel frame given panel rotation (rx, ry, rz) in degrees.

theta = deg2rad(el_deg);
phi = deg2rad(az_deg);
r = deg2rad(rotation_deg(:)');
rx = r(1); ry = r(2); rz = r(3);

sin_az = sin(phi - rz); cos_az = cos(phi - rz);
sin_y = sin(ry); cos_y = cos(ry);
sin_x = sin(rx); cos_x = cos(rx);
sin_t = sin(theta); cos_t = cos(theta);

arg = cos_y * cos_x * cos_t + sin_t .* ...
    (sin_y * cos_x * cos_az - sin_x * sin_az);
theta_rot = acos(min(max(arg, -1), 1));
phi_rot = angle((cos_y * sin_t .* cos_az - sin_y * cos_t) + ...
    1j * (cos_y * sin_x * cos_t + ...
          sin_t .* (sin_y * sin_x * cos_az + cos_x * sin_az)));
end
