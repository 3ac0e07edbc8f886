function [raydata, meta] = read_v3_scenario(scenario_folder, bs_id, polar)
% READ_V3_SCENARIO  Read a published DeepMIMO v3 scenario folder directly.
%
%   [raydata, meta] = read_v3_scenario(folder)            % BS 1
%   [raydata, meta] = read_v3_scenario(folder, bs_id)
%   [raydata, meta] = read_v3_scenario(folder, bs_id, 'VV')  % dual-polar
%
% Consumes the standard v3 on-disk layout with NO Python prerequisite:
% params.mat (or <name>.params.mat) plus chunked BS{i}_UE_{start}-{end}.mat
% files whose `channels` cell array holds structs with field `p` = the
% [8..10 x n_paths] path matrix of rows [phase(deg); ToA(s); power(dBm);
% DoA az; DoA el; DoD az; DoD el; LoS(; dop_vel; dop_acc)] — the same
% contract the reference MATLAB reader indexes (data.channels{u}.p,
% reference DeepMIMO-matlab/DeepMIMO_functions/readers/
% read_raytracing_v3.m:76-80). Bare-matrix cells (older exports) are
% accepted too. For dual-polarization scenarios pass polar in
% {'VV','VH','HH','HV'} to select a `channels_XX` block.
%
% Returns:
%   raydata: struct with fields
%     .paths    {n_ue x 1} cell of path matrices (double)
%     .rx_locs  [n_ue x >=3] receiver locations (cols 4/5 = distance,
%               pathloss when present)
%     .tx_loc   [1 x 3] transmitter location
%   meta: params.mat contents (carrier_freq, transmit_power, num_BS,
%     user_grids, doppler_available, dual_polar_available)

if nargin < 2, bs_id = 1; end
if nargin < 3, polar = ''; end

% ---- params.mat (allow the <name>.params.mat naming) ----
pf = fullfile(scenario_folder, 'params.mat');
if ~exist(pf, 'file')
    cand = dir(fullfile(scenario_folder, '*params.mat'));
    assert(~isempty(cand), 'No params.mat in %s', scenario_folder);
    pf = fullfile(scenario_folder, cand(1).name);
end
meta = load(pf);

key = 'channels';
if ~isempty(polar)
    assert(isfield(meta, 'dual_polar_available') && ...
           meta.dual_polar_available, ...
           'Scenario has no dual-polarization blocks');
    key = ['channels_' upper(polar)];
end

% ---- gather user chunks in ascending start order ----
files = dir(fullfile(scenario_folder, sprintf('BS%d_UE_*.mat', bs_id)));
assert(~isempty(files), 'No BS%d_UE_*.mat chunks in %s', bs_id, ...
       scenario_folder);
starts = zeros(numel(files), 1);
for f = 1:numel(files)
    tok = sscanf(files(f).name, sprintf('BS%d_UE_%%d-%%d.mat', bs_id));
    starts(f) = tok(1);
end
[~, order] = sort(starts);

paths = {};
rx_locs = [];
tx_loc = [];
for f = order(:)'
    chunk = load(fullfile(scenario_folder, files(f).name));
    assert(isfield(chunk, key), 'Chunk %s has no %s block', ...
           files(f).name, key);
    cells = chunk.(key);
    for u = 1:numel(cells)
        pm = cells{u};
        if isstruct(pm), pm = pm.p; end           % canonical struct cell
        paths{end+1, 1} = double(pm);             %#ok<AGROW>
    end
    if isfield(chunk, 'rx_locs')
        rx_locs = [rx_locs; double(chunk.rx_locs)];   %#ok<AGROW>
    end
    if isfield(chunk, 'tx_loc')
        tx_loc = double(chunk.tx_loc(:)');
    end
end

% tx_loc fallback: the BS file (reference raytracing_v3.py:169-171)
if isempty(tx_loc)
    bsf = fullfile(scenario_folder, sprintf('BS%d_BS.mat', bs_id));
    if exist(bsf, 'file')
        bs_data = load(bsf);
        if isfield(bs_data, 'BS_loc')
            tx_loc = double(bs_data.BS_loc(:)');
        elseif isfield(bs_data, 'rx_locs')
            tx_loc = double(bs_data.rx_locs(bs_id, 1:3));
        end
    end
end

% rx_locs fallback: separate UE_locations.mat (older exports)
if isempty(rx_locs)
    uef = fullfile(scenario_folder, 'UE_locations.mat');
    if exist(uef, 'file')
        ue = load(uef);
        rx_locs = double(ue.UE_loc);
    end
end

raydata.paths = paths;
raydata.rx_locs = rx_locs;
raydata.tx_loc = tx_loc;
end
