function keep = fov_mask(fov_deg, theta_rad, phi_rad)
% FOV_MASK  Keep paths inside an (az, el) field of view (degrees).
%
% Applied to ROTATED angles; azimuth window centered on boresight, the
% elevation window on the horizon — same convention as
% deepmimo_tpu/ops/geometry.py (oracle: tests/oracle.py:oracle_fov_mask).

fov = deg2rad(fov_deg(:)');
theta = mod(theta_rad, 2 * pi);
phi = mod(phi_rad, 2 * pi);
inc_phi = (phi <= fov(1) / 2) | (phi >= 2 * pi - fov(1) / 2);
inc_theta = (theta <= pi / 2 + fov(2) / 2) & (theta >= pi / 2 - fov(2) / 2);
keep = inc_phi & inc_theta;
end
