function [channels, info] = DeepMIMO_TPU_generate(scenario_folder, params)
% DEEPMIMO_TPU_GENERATE  MIMO channels from a v3 scenario folder.
%
%   [channels, info] = DeepMIMO_TPU_generate(folder, params)
%
% Consumes any published DeepMIMO v3 scenario folder (params.mat +
% BS{i}_UE_{start}-{end}.mat path chunks) directly via read_v3_scenario —
% no Python step required — including folders written by
% deepmimo_tpu.integrations.export_matlab. Synthesizes channels with the
% same math as the deepmimo_tpu renderer (capability parity with the
% reference's vendored MATLAB generator, reference deepmimo/integrations/
% matlab/DeepMIMO-matlab/; fresh implementation validated against
% tests/oracle.py formulas).
%
% params: struct from default_params(), fields documented there. Extra
% optional field params.polarization in {'', 'VV','VH','HH','HV'} selects
% a dual-polarization block when the scenario provides them.
%
% Returns:
%   channels: {num_BS x 1} cell; channels{b} is [n_ue x 1] cell of
%     [R x T x K] (freq domain) or [R x T x L] (time domain) complex
%     channels. With params.enable_doppler, a 4th dim of
%     numel(params.doppler_times) snapshots is added.
%   info: struct with BS/UE locations and per-user path counts.

if nargin < 2, params = default_params(); end
polar = '';
if isfield(params, 'polarization'), polar = params.polarization; end

meta = load_meta(scenario_folder);
num_bs = double(meta.num_BS);
tx_power = double(meta.transmit_power);      % dBm re-reference (v3 format)
fc = double(meta.carrier_freq);
has_doppler = isfield(meta, 'doppler_available') && meta.doppler_available;

channels = cell(num_bs, 1);
info.bs_locations = cell(num_bs, 1);
info.num_paths = cell(num_bs, 1);

for b = 1:num_bs
    [raydata, ~] = read_v3_scenario(scenario_folder, b, polar);
    info.bs_locations{b} = raydata.tx_loc;
    if b == 1 && ~isempty(raydata.rx_locs)
        info.ue_locations = raydata.rx_locs(:, 1:3);
    end

    n_ue = numel(raydata.paths);
    user_ch = cell(n_ue, 1);
    n_paths = zeros(n_ue, 1);
    for u = 1:n_ue
        [h, np_used] = construct_channel(raydata.paths{u}, tx_power, ...
                                         fc, has_doppler, params);
        user_ch{u} = h;
        n_paths(u) = np_used;
    end
    channels{b} = user_ch;
    info.num_paths{b} = n_paths;
end
end

function meta = load_meta(scenario_folder)
pf = fullfile(scenario_folder, 'params.mat');
if ~exist(pf, 'file')
    cand = dir(fullfile(scenario_folder, '*params.mat'));
    assert(~isempty(cand), 'No params.mat in %s', scenario_folder);
    pf = fullfile(scenario_folder, cand(1).name);
end
meta = load(pf);
end
